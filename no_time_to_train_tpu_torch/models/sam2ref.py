"""SAM2Ref, the trainable custom-IoU variant (port of
`no_time_to_train_tpu/models/sam2ref.py`; reference
no_time_to_train/models/SAM2Ref.py): a frozen SAM2 plus a learnable
custom-IoU head trained to regress the oracle mask IoU, with reference
images injected through SAM2's memory attention.

Trainable parameters, `RefHeads` (reference :51-64, the reference's torch
names):
  - mem_feat_ref_pe [1, mem_dim]: additive PE marking reference memories;
  - iou_embed [1, C]: the custom IoU token appended to the sparse prompts
    (hidden from self-attention and the image side by skip_last_n_keys=2);
  - iou_prediction_head: MLP(C, 256, 4, 3, sigmoid).

Batches have fixed shapes as in the JAX package: (item, category) pairs
flattened to a G axis with validity, references padded to R per category,
GT instances padded to I. The kernels carry the frozen encoders, the memory
fusion and the decode of fill and test; the differentiated part of the train
step runs their plain versions (see `train_loss`).
"""
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.models.matching.pipeline import (
    IMAGENET_MEAN, IMAGENET_STD, grid_points)
from no_time_to_train_tpu_torch.models.sam2.common import MLP
from no_time_to_train_tpu_torch.models.sam2.pos_enc import sine_pos_table
from no_time_to_train_tpu_torch.ops.attention import set_attention_impl
from no_time_to_train_tpu_torch.ops.masks import batched_mask_to_box
from no_time_to_train_tpu_torch.ops.nms import batched_nms, take_first_kept
from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion

__all__ = ["RefHeads", "Sam2RefConfig", "SAM2Ref", "NO_DECAY_TOKENS",
           "decays"]

# a parameter whose lowercased name holds one of these takes no weight decay
# (the JAX package's mask over the tree path, reference sam2ref_pl.py)
NO_DECAY_TOKENS = ("norm", "bn", "ln", "bias", "pe", "embed")


def decays(name):
    """True when the parameter `name` takes weight decay."""
    name = name.lower()
    return not any(t in name for t in NO_DECAY_TOKENS)


class RefHeads(nn.Module):
    """The trainable leaves, float32."""

    def __init__(self, transformer_dim, mem_dim, num_mask_tokens=4,
                 iou_head_hidden=256, iou_head_depth=3):
        super().__init__()
        self.mem_feat_ref_pe = nn.Embedding(1, mem_dim)
        self.iou_embed = nn.Embedding(1, transformer_dim)
        self.iou_prediction_head = MLP(transformer_dim, iou_head_hidden,
                                       num_mask_tokens, iou_head_depth,
                                       sigmoid_output=True)

    @torch.no_grad()
    def init_(self, generator):
        """Every parameter N(0, 0.02) from a CPU `generator`."""
        for p in self.parameters():
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        return self

    def forward(self, token_out):
        return self.iou_prediction_head(token_out)


@dataclass
class Sam2RefConfig:
    skip_custom_iou_in_attn: bool = True
    semantic_ref: bool = True
    n_categories: int = 20
    memory_length: int = 1
    testing_point_bs: int = 256
    testing_nms_iou_thr: float = 0.7
    testing_out_num: int = 100

    @property
    def n_skip_tokens_in_attn(self):
        # add_semantic_token=False (+1) and custom iou token present (+1)
        return 2 if self.skip_custom_iou_in_attn else 0


class SAM2Ref:
    """sam2: the port's SAM2 with its weights loaded. SAM2Ref takes the
    module over: it is frozen, moved to `dtype` on `device` and set to
    attention_impl="pallas" in place, as the matcher does; the heads stay
    float32. `device` defaults to CUDA and raises
    without it; tests pass device="cpu", where every kernel entry runs its
    plain version."""

    def __init__(self, sam2, cfg=None, device="cuda", dtype=torch.float32,
                 seed=0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SAM2Ref wants a CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.dtype = dtype
        self.sam2 = set_attention_impl(
            sam2.to(device=self.device, dtype=dtype).eval()
            .requires_grad_(False), "pallas")
        self.cfg = cfg or Sam2RefConfig()
        c = sam2.cfg
        self.heads = RefHeads(c.hidden_dim, c.mem_dim).init_(
            torch.Generator().manual_seed(seed)).to(self.device)
        hw = c.sam_image_embedding_size
        self.mem_feat_size = hw * hw
        f32 = dict(dtype=torch.float32, device=self.device)
        # raw-tensor memory bank (reference buffers :92-117); the fill
        # counts stay on the host
        self.memory_bank = torch.zeros(
            (self.cfg.n_categories, self.cfg.memory_length,
             self.mem_feat_size, c.mem_dim), **f32)
        self.memory_pe = torch.zeros((self.mem_feat_size, c.mem_dim), **f32)
        self.memory_fill = torch.zeros((self.cfg.n_categories,),
                                       dtype=torch.int32)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    # ------------------------------------------------------------ internals
    def _normalize(self, img):
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return ((img - self._mean) / self._std).to(self.dtype)

    def _target(self, imgs):
        """imgs [B, S, S, 3] in [0, 1] -> (FPN levels, flat lowest level
        [B, hw^2, C], its position encoding [B, hw^2, C])."""
        c = self.sam2.cfg
        hw = c.sam_image_embedding_size
        fpn = self.sam2.forward_image(self._normalize(imgs))["backbone_fpn"]
        b = fpn[-1].shape[0]
        pos = sine_pos_table(hw, hw, c.d_model, dtype=self.dtype,
                             device=self.device)
        return (fpn, fpn[-1].reshape(b, hw * hw, c.d_model),
                pos.reshape(1, hw * hw, c.d_model).expand(b, -1, -1))

    def _encode_reference_memory(self, ref_imgs, ref_masks):
        """refs -> memory features via mask-as-output + force-binarized
        memory encoder (reference _forward_references :214-250, semantic
        path)."""
        out = self.sam2.forward_image(self._normalize(ref_imgs))
        pix = out["backbone_fpn"][-1]
        masks = torch.as_tensor(ref_masks, dtype=torch.float32,
                                device=self.device)
        high_res_masks = masks * 20.0 - 10.0
        return self.sam2.encode_memory(pix, high_res_masks[..., None], False,
                                       True)

    def _fuse_with_memory(self, tar_flat, tar_pe, memory, memory_pos,
                          memory_valid=None):
        """Memory attention with the reference-marking PE added
        (reference _forward_memory_* :252-349)."""
        pe = self.heads.mem_feat_ref_pe.weight[0]
        return self.sam2.memory_conditioned_features(
            tar_flat, tar_pe, memory, memory_pos + pe, 0, memory_valid)

    def _decode_with_custom_iou(self, pix, hr, coords, labels):
        """The decoder with the custom IoU token appended to the sparse
        prompts and hidden from attention (reference
        _forward_decoder_testing :351-410). pix [1 or B, h, w, C]; coords
        [B, 1, 2]. Returns (masks [B, 4, 4h, 4w] float32, SAM ious [B, 4],
        custom ious [B, 4] float32)."""
        pe = self.sam2.sam_prompt_encoder
        sparse = pe.embed_points(coords, labels)
        tok = self.heads.iou_embed.weight[None].expand(
            sparse.shape[0], 1, sparse.shape[-1]).to(sparse.dtype)
        sparse = torch.cat([sparse, tok], dim=1)
        masks, ious, _, _, my_token = self.sam2.sam_mask_decoder(
            pix, pe.get_dense_pe(), sparse, pe.no_mask_dense(), True,
            high_res_features=hr, output_all_masks=True,
            return_iou_token_out=True, disable_custom_iou_embed=False,
            skip_last_n_keys=self.cfg.n_skip_tokens_in_attn)
        custom_iou = self.heads(my_token.float())
        return masks.float(), ious, custom_iou

    # ---------------------------------------------------------------- train
    def train_loss(self, batch):
        """batch (tensors or arrays): tar_imgs [G, S, S, 3] (target per
        (item, cat) pair), ref_imgs [G, R, S, S, 3], ref_masks [G, R, S, S],
        query_points [G, P, 2], gt_masks [G, I, S/4, S/4] bool, gt_valid
        [G, I], cat_valid [G]. Returns (loss, metrics).

        The two encoder passes (the targets' forward_image, the references'
        forward_image and encode_memory) take no gradient from the three
        leaves, so they run under torch.no_grad() with the kernels live.
        The rest, which the loss differentiates through (the memory
        attention with mem_feat_ref_pe, the decode with iou_embed, the IoU
        head, the loss), runs inside no_fusion(): no kernel has a backward,
        in the JAX package (whose step runs all of it under no_fusion())
        or here, and the kernels refuse operands that require grad."""
        c = self.sam2.cfg
        dev = self.device
        tensor = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                     else v, device=dev)
                  for k, v in batch.items()}
        g, r = tensor["ref_imgs"].shape[:2]
        p = tensor["query_points"].shape[1]
        s = c.image_size
        hw = c.sam_image_embedding_size

        with torch.no_grad():
            fpn, tar_flat, pe_flat = self._target(tensor["tar_imgs"])
            mem_feat, mem_pos = self._encode_reference_memory(
                tensor["ref_imgs"].reshape(g * r, s, s, 3),
                tensor["ref_masks"].reshape(g * r, s, s))
        mem_dim = mem_feat.shape[-1]
        mem = mem_feat.reshape(g, r * self.mem_feat_size, mem_dim)
        mpos = mem_pos.reshape(g, r * self.mem_feat_size, mem_dim)

        with no_fusion():
            fused = self._fuse_with_memory(tar_flat, pe_flat, mem, mpos)
            fused = fused.reshape(g, hw, hw, c.d_model)
            # decode every query point (G * P prompts, each on its image)
            pix = fused.repeat_interleave(p, dim=0)
            hr = ([fpn[0].repeat_interleave(p, dim=0),
                   fpn[1].repeat_interleave(p, dim=0)]
                  if c.use_high_res_features_in_sam else None)
            coords = tensor["query_points"].float().reshape(g * p, 1, 2)
            labels = torch.ones((g * p, 1), dtype=torch.long, device=dev)
            masks, _, custom_iou = self._decode_with_custom_iou(
                pix, hr, coords, labels)

            # matched oracle IoU (reference _compute_matched_iou_matrix
            # :138-157)
            pred = (masks > 0).reshape(g, p * 4, -1).float()
            gt = tensor["gt_masks"].reshape(g, -1, pred.shape[-1]).bool()
            gt = gt.float()
            inter = torch.einsum("gqn,gin->gqi", pred, gt)
            area_p = pred.sum(-1)[:, :, None]
            area_g = gt.sum(-1)[:, None, :]
            union = area_p + area_g - inter
            iou = torch.where(union > 0, inter / union.clamp(min=1.0),
                              torch.zeros_like(inter))
            iou = torch.where(tensor["gt_valid"].bool()[:, None, :], iou,
                              torch.full_like(iou, -1.0))
            matched = iou.amax(dim=-1).clamp(min=0.0)

            w = tensor["cat_valid"].float().repeat_interleave(p * 4)
            err = (matched.reshape(-1) - custom_iou.reshape(-1)).abs()
            loss = (err * w).sum() / w.sum().clamp(min=1.0)
        metrics = {"mean_seg_iou":
                   ((matched.reshape(-1) * w).sum()
                    / w.sum().clamp(min=1.0)).detach(),
                   "matched_iou": matched.reshape(-1).detach(),
                   "pred_iou": custom_iou.reshape(-1).detach(),
                   "weight": w}
        return loss, metrics

    def make_optimizer(self, base_lr=1e-4, weight_decay=0.05,
                       warmup_iters=500, decay_steps=(), world_size=1,
                       base_bs=8, train_bs=8):
        """AdamW with a no-decay split + linear warm-up + multi-step 0.1
        decay, lr scaled by the total batch size (reference
        sam2ref_pl.py:145-185). Returns (optimizer, scheduler); the
        scheduler steps once after each optimizer step, so that step k
        takes lr * schedule(k) as the JAX package's optax chain does."""
        lr = base_lr * (train_bs * world_size) / base_bs
        decay_steps = tuple(decay_steps)

        def schedule(step):
            warm = min(1.0, (step + 1) / max(warmup_iters, 1))
            decay = 1.0
            for d in decay_steps:
                if step >= d:
                    decay *= 0.1
            return warm * decay

        named = list(self.heads.named_parameters())
        groups = [
            {"params": [q for n, q in named if decays(n)],
             "weight_decay": weight_decay},
            {"params": [q for n, q in named if not decays(n)],
             "weight_decay": 0.0}]
        opt = torch.optim.AdamW(groups, lr=lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    def make_train_step(self, optimizer, scheduler):
        """step(batch) -> (loss, metrics): one update of the heads. The
        gradients of the step stay on the heads' `.grad` until the next."""
        def step(batch):
            optimizer.zero_grad(set_to_none=True)
            loss, metrics = self.train_loss(batch)
            loss.backward()
            optimizer.step()
            scheduler.step()
            return loss.detach(), metrics
        return step

    # ----------------------------------------------------------- fill / test
    @torch.no_grad()
    def fill_memory(self, cat_ind, ref_imgs, ref_masks):
        """One category's references -> its next bank slot (reference
        forward_fill_memory :598-648); a slot past the bank's length is
        dropped, as the JAX scatter drops it."""
        mem_feat, mem_pos = self._encode_reference_memory(ref_imgs,
                                                          ref_masks)
        feat = mem_feat.reshape(-1, self.mem_feat_size, mem_feat.shape[-1])
        slot = int(self.memory_fill[cat_ind])
        if slot < self.cfg.memory_length:
            self.memory_bank[cat_ind, slot] = feat[0].float()
        self.memory_pe = mem_pos.reshape(
            -1, self.mem_feat_size, mem_pos.shape[-1])[0].float()
        self.memory_fill[cat_ind] += 1

    def decode_candidates(self, tar_img, points):
        """Per-category memory fusion + grid decode ranked by iou x
        custom_iou (reference _forward_memory_testing :303-349 +
        forward_test :650-775): tar_img [S, S, 3] in [0, 1], points [N, 2].
        Returns (masks [n_cat * N, 4h, 4w] float32, scores [n_cat * N]),
        category-major. The categories x chunks loops are Python loops
        where the JAX package maps; nothing waits on the device."""
        c = self.sam2.cfg
        n_cat, length = self.memory_bank.shape[:2]
        hw = c.sam_image_embedding_size
        fpn, tar_flat, pe_flat = self._target(
            torch.as_tensor(tar_img, device=self.device)[None])
        tar_flat = tar_flat.expand(n_cat, -1, -1)
        pe_flat = pe_flat.expand(n_cat, -1, -1)
        mem = self.memory_bank.reshape(n_cat, -1, self.memory_bank.shape[-1])
        mpe = self.memory_pe[None].expand(n_cat * length, -1, -1).reshape(
            n_cat, -1, self.memory_pe.shape[-1])
        fused = self._fuse_with_memory(tar_flat, pe_flat, mem, mpe)
        fused = fused.reshape(n_cat, hw, hw, c.d_model)

        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        n_pts = points.shape[0]
        chunk = min(self.cfg.testing_point_bs, n_pts)
        labels = torch.ones((chunk, 1), dtype=torch.long, device=self.device)
        bi = torch.arange(chunk, device=self.device)
        masks, scores = [], []
        for ci in range(n_cat):
            for i in range(0, n_pts, chunk):
                m, ious, custom = self._decode_with_custom_iou(
                    fused[ci:ci + 1], [fpn[0], fpn[1]],
                    points[i:i + chunk, None], labels)
                score = ious.float() * custom
                best = torch.argmax(score, dim=-1)
                masks.append(m[bi, best])
                scores.append(score[bi, best])
        return torch.cat(masks), torch.cat(scores)

    def select(self, masks, scores):
        """Class-aware NMS and the top `testing_out_num` of the candidates
        of `decode_candidates`. The NMS's fixed point is the one place that
        waits on the device (ops/nms.batched_nms, as in the matcher)."""
        n_cat = self.memory_bank.shape[0]
        n_pts = scores.shape[0] // n_cat
        labels = torch.arange(n_cat, device=scores.device
                              ).repeat_interleave(n_pts)
        boxes = batched_mask_to_box(masks > 0).float()
        order, keep = batched_nms(boxes, scores, labels,
                                  torch.ones_like(scores, dtype=torch.bool),
                                  self.cfg.testing_nms_iou_thr)
        sel, sel_valid = take_first_kept(order, keep,
                                         self.cfg.testing_out_num)
        return dict(lr_logits=masks[sel].half(),
                    scores=torch.where(sel_valid, scores[sel],
                                       torch.zeros_like(scores[sel])),
                    labels=labels[sel], valid=sel_valid)

    @torch.no_grad()
    def forward_test(self, tar_img, points_per_side=32):
        """tar_img [S, S, 3] in [0, 1] -> dict of device tensors:
        lr_logits [K, 4h, 4w] float16, scores [K], labels [K], valid [K]."""
        pts = grid_points(points_per_side, self.sam2.cfg.image_size,
                          device=self.device)
        return self.select(*self.decode_candidates(tar_img, pts))
