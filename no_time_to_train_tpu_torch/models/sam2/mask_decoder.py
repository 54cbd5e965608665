"""SAM2 mask decoder (port of
`no_time_to_train_tpu/models/sam2/mask_decoder.py`; reference
sam2/modeling/sam/mask_decoder.py).

Two paths: the grid decode's `predict_best_of_multimask`, whose upscale
chain runs in the unshuffled product layout through kernel K4
(ops/upscale_product.fused_post_t1), and the classic `predict_masks` /
`forward` of the SAM heads (video tracking, prompts with a mask), whose
upscale chain is plain. The vendored reference keeps the object-score head
dead and returns a constant score of 10; its parameters are held for
checkpoint compatibility. The classic route carries the NTTT extras of the
JAX decoder used by SAM2Ref (models/sam2ref.py): `skip_last_n_keys`, which
hides the last sparse tokens from self-attention and from the image side,
and `return_iou_token_out` / `disable_custom_iou_embed`, which return the
output of the custom IoU token appended last to the sparse prompts (or of
the SAM IoU token).
"""
import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import (
    LayerNorm2d, MLP, _gelu_act, conv_transpose_2x2_s2)
from no_time_to_train_tpu_torch.models.sam2.transformer import (
    TwoWayTransformer, call_step)
from no_time_to_train_tpu_torch.ops.upscale_product import (
    fold_skips, fused_post_t1)

__all__ = ["MaskDecoder", "OBJECT_SCORE_LOGIT"]

OBJECT_SCORE_LOGIT = 10.0


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim=256, num_multimask_outputs=3,
                 iou_head_depth=3, iou_head_hidden_dim=256,
                 use_high_res_features=True, iou_prediction_use_sigmoid=True,
                 pred_obj_scores=True, pred_obj_scores_mlp=True,
                 transformer_depth=2, transformer_mlp_dim=2048,
                 transformer_num_heads=8,
                 dynamic_multimask_via_stability=False,
                 dynamic_multimask_stability_delta=0.05,
                 dynamic_multimask_stability_thresh=0.98,
                 use_multimask_token_for_obj_ptr=False):
        super().__init__()
        d = transformer_dim
        self.dynamic_multimask_via_stability = dynamic_multimask_via_stability
        self.dynamic_multimask_stability_delta = \
            dynamic_multimask_stability_delta
        self.dynamic_multimask_stability_thresh = \
            dynamic_multimask_stability_thresh
        self.use_multimask_token_for_obj_ptr = use_multimask_token_for_obj_ptr
        self.transformer_dim = d
        self.num_mask_tokens = num_multimask_outputs + 1
        self.pred_obj_scores = pred_obj_scores
        self.use_high_res_features = use_high_res_features
        self.transformer = TwoWayTransformer(
            transformer_depth, d, transformer_num_heads, transformer_mlp_dim)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        if pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2),
            nn.GELU())
        if use_high_res_features:
            self.conv_s0 = nn.Conv2d(d, d // 8, 1)
            self.conv_s1 = nn.Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(
            d, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth,
            sigmoid_output=iou_prediction_use_sigmoid)
        if pred_obj_scores:
            self.pred_obj_score_head = (MLP(d, d, 1, 3) if pred_obj_scores_mlp
                                        else nn.Linear(d, 1))

    def _tokens(self, sparse_prompt_embeddings):
        """Output tokens (object score, IoU, masks) in front of the sparse
        prompt embeddings; returns (tokens [B, N, C], index of the IoU
        token)."""
        toks = [self.iou_token.weight, self.mask_tokens.weight]
        if self.pred_obj_scores:
            toks = [self.obj_score_token.weight] + toks
        bs = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat(toks, dim=0)
        tokens = torch.cat([output_tokens[None].expand(bs, -1, -1),
                            sparse_prompt_embeddings], dim=1)
        return tokens, (1 if self.pred_obj_scores else 0)

    def predict_masks(self, image_embeddings, image_pe,
                      sparse_prompt_embeddings, dense_prompt_embeddings,
                      high_res_features=None, return_iou_token_out=False,
                      disable_custom_iou_embed=False, skip_last_n_keys=0):
        """image_embeddings, dense: [B or 1, h, w, C]; image_pe [h, w, C];
        sparse [B, N, C]. Returns (masks [B, M, 4h, 4w], iou [B, M], mask
        tokens [B, M, C], object score logits [B, 1], the constant 10, and
        the IoU token output [B, C] with `return_iou_token_out`, else None):
        the last token's (the custom IoU token's), or the SAM IoU token's
        with `disable_custom_iou_embed`."""
        tokens, s = self._tokens(sparse_prompt_embeddings)
        bs = tokens.shape[0]
        # a batch of 1 on the image side stays 1 until the keys diverge
        src = image_embeddings + dense_prompt_embeddings
        b, (h, w, c) = bs, src.shape[1:]
        hs, src_out = self.transformer(src, image_pe[None], tokens,
                                       skip_last_n_keys=skip_last_n_keys)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]
        my_iou_token_out = None
        if return_iou_token_out:
            my_iou_token_out = (iou_token_out if disable_custom_iou_embed
                                else hs[:, -1])

        dc1, ln, dc2 = (self.output_upscaling[0], self.output_upscaling[1],
                        self.output_upscaling[3])
        up = conv_transpose_2x2_s2(src_out.reshape(b, h, w, c), dc1.weight,
                                   dc1.bias)
        if self.use_high_res_features:
            feat_s0, feat_s1 = high_res_features
            up = _gelu_act(ln(up + feat_s1))
            up = conv_transpose_2x2_s2(up, dc2.weight, dc2.bias)
            up = _gelu_act(up + feat_s0)
        else:
            up = _gelu_act(ln(up))
            up = _gelu_act(conv_transpose_2x2_s2(up, dc2.weight, dc2.bias))
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
             for i in range(self.num_mask_tokens)], dim=1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper_in, up)
        iou_pred = self.iou_prediction_head(iou_token_out)
        object_score_logits = iou_pred.new_full((bs, 1), OBJECT_SCORE_LOGIT)
        return (masks, iou_pred, mask_tokens_out, object_score_logits,
                my_iou_token_out)

    def _get_stability_scores(self, mask_logits):
        flat = mask_logits.flatten(-2)
        d = self.dynamic_multimask_stability_delta
        area_i = (flat > d).sum(dim=-1).float()
        area_u = (flat > -d).sum(dim=-1).float()
        return torch.where(area_u > 0, area_i / area_u,
                           torch.ones_like(area_u))

    def _dynamic_multimask_via_stability(self, all_mask_logits,
                                         all_iou_scores):
        """The single-mask output where it is stable, else the best of the
        multimask outputs."""
        multimask_logits = all_mask_logits[:, 1:]
        multimask_iou = all_iou_scores[:, 1:]
        best = torch.argmax(multimask_iou, dim=-1)
        bi = torch.arange(best.shape[0], device=best.device)
        best_logits = multimask_logits[bi, best][:, None]
        best_scores = multimask_iou[bi, best][:, None]
        single_logits = all_mask_logits[:, 0:1]
        single_iou = all_iou_scores[:, 0:1]
        stable = (self._get_stability_scores(single_logits)
                  >= self.dynamic_multimask_stability_thresh)
        return (torch.where(stable[..., None, None], single_logits,
                            best_logits),
                torch.where(stable, single_iou, best_scores))

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output,
                high_res_features=None, output_all_masks=False,
                return_iou_token_out=False, disable_custom_iou_embed=False,
                skip_last_n_keys=0):
        """Returns (masks, iou predictions, SAM output tokens, object score
        logits): all four mask channels with `output_all_masks`, channels
        1..3 with `multimask_output`, else one mask; with
        `return_iou_token_out` the IoU token output of `predict_masks` as a
        fifth value."""
        masks, iou_pred, mask_tokens_out, object_score_logits, iou_tok = (
            self.predict_masks(image_embeddings, image_pe,
                               sparse_prompt_embeddings,
                               dense_prompt_embeddings, high_res_features,
                               return_iou_token_out, disable_custom_iou_embed,
                               skip_last_n_keys))
        extra = (iou_tok,) if return_iou_token_out else ()
        if output_all_masks:
            return (masks, iou_pred, mask_tokens_out, object_score_logits,
                    *extra)
        if multimask_output:
            masks, iou_pred = masks[:, 1:], iou_pred[:, 1:]
        elif self.dynamic_multimask_via_stability:
            masks, iou_pred = self._dynamic_multimask_via_stability(
                masks, iou_pred)
        else:
            masks, iou_pred = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and self.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return masks, iou_pred, sam_tokens_out, object_score_logits, *extra

    def predict_best_of_multimask(self, image_embeddings, image_pe,
                                  sparse_prompt_embeddings,
                                  dense_prompt_embeddings,
                                  high_res_features=None):
        """image_embeddings [Bi, h, w, C]; dense [1, h, w, C]; image_pe
        [h, w, C]; sparse [B, N, C], the B / Bi prompts of an image lying
        together; high_res_features with Bi rows. Runs the transformer,
        picks the best of the multimask outputs (channels 1..3) by predicted
        IoU and computes only that mask. Returns (mask [B, 4h, 4w],
        iou [B])."""
        tokens = self._tokens(sparse_prompt_embeddings)[0]
        return self.best_of_multimask_from_tokens(
            image_embeddings, image_pe, tokens, dense_prompt_embeddings,
            high_res_features)

    def best_of_multimask_from_tokens(self, image_embeddings, image_pe,
                                      tokens, dense_prompt_embeddings,
                                      high_res_features=None,
                                      step=call_step):
        """`predict_best_of_multimask` on the output tokens in front of the
        sparse prompts ([B, N, C], `_tokens`). `step` runs the token-side
        steps (`transformer.call_step`): the transformer's, then "heads"
        (the IoU head, the hypernetworks and the best of channels 1..3)."""
        # the image side keeps its own batch: the prompt-independent
        # projections of layer 0 are computed once per image until the keys
        # diverge per prompt
        src = image_embeddings + dense_prompt_embeddings
        h, w = src.shape[1:3]
        hs, src_out = self.transformer(src, image_pe[None], tokens,
                                       step=step)
        hyper, iou = step("heads", self._best_heads, hs)
        return self._upscale_product_unshuffled(
            src_out, hyper, h, w, high_res_features), iou

    def _best_heads(self, hs):
        """(the hypernetwork output [B, C / 8] and the IoU [B] of the best
        of channels 1..3) from the transformer's tokens hs."""
        s = 1 if self.pred_obj_scores else 0
        iou_pred = self.iou_prediction_head(hs[:, s])
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]
        best = torch.argmax(iou_pred[:, 1:], dim=-1) + 1
        bi = torch.arange(hs.shape[0], device=best.device)
        hyper_all = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
             for i in range(self.num_mask_tokens)], dim=1)
        return hyper_all[bi, best], iou_pred[bi, best]

    def _upscale_product_unshuffled(self, src_flat, hyper, h, w,
                                    high_res_features):
        """Output upscaling and hypernetwork product in the deconvolutions'
        unshuffled layout: rows (y, x), cols (phase, channel). Only the final
        [B, 4h, 4w] mask is re-ordered. The skips are re-laid once per
        image."""
        b = src_flat.shape[0]
        d = self.transformer_dim
        c1, c2 = d // 4, d // 8
        hw = h * w
        dc1, ln, dc2 = (self.output_upscaling[0], self.output_upscaling[1],
                        self.output_upscaling[3])
        k1 = dc1.weight.permute(0, 2, 3, 1).reshape(d, 4 * c1)
        k2 = dc2.weight.permute(0, 2, 3, 1).reshape(c1, 4 * c2)
        if high_res_features is not None:
            feat_s0, feat_s1 = high_res_features
            bi = feat_s1.shape[0]
            # [Bi, 2h, 2w, c1] -> rows (y, x), cols (dy1, dx1, c1)
            s1f = feat_s1.reshape(bi, h, 2, w, 2, c1) \
                .permute(0, 1, 3, 2, 4, 5).reshape(bi, hw, 4 * c1)
            # [Bi, 4h, 4w, c2] -> rows (y, x), cols (dy1, dx1, dy2, dx2, c2)
            s0f16 = feat_s0.reshape(bi, h, 2, 2, w, 2, 2, c2) \
                .permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(bi, hw, 16 * c2)
        else:
            s1f = src_flat.new_zeros(1, hw, 4 * c1)
            s0f16 = src_flat.new_zeros(1, hw, 16 * c2)
        s1p, s0p = fold_skips(dc1.bias.repeat(4), s1f, dc2.bias, s0f16)
        m16 = fused_post_t1(src_flat.reshape(b, hw, d).contiguous(), k1, s1p,
                            ln.weight, ln.bias, k2, s0p, hyper, eps=ln.eps)
        # [b, (dy1, dx1, dy2, dx2), (y, x)] -> [b, 4h, 4w]
        return (m16.reshape(b, 2, 2, 2, 2, h, w)
                .permute(0, 5, 1, 3, 6, 2, 4).reshape(b, 4 * h, 4 * w))
