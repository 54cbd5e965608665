"""Memory attention of the SAM2 video path (port of
`no_time_to_train_tpu/models/sam2/memory_attention.py`; reference
sam2/modeling/memory_attention.py).

Batch-first: curr [B, N, C], memory [B, M, mem_dim]. Each layer is RoPE
self-attention over the frame's tokens, RoPE cross-attention to the memory
bank (keys repeat the query grid once per memory row; the object-pointer
tokens at the end are not rotated; `memory_valid` masks the padded slots of
the fixed-shape bank) and a feed-forward block. Inference only: no dropout.
"""
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import ACT, LayerNorm
from no_time_to_train_tpu_torch.models.sam2.transformer import RoPEAttention

__all__ = ["MemoryAttentionLayer", "MemoryAttention"]


class MemoryAttentionLayer(nn.Module):
    def __init__(self, d_model=256, dim_feedforward=2048, activation="relu",
                 pos_enc_at_attn=False, pos_enc_at_cross_attn_keys=True,
                 pos_enc_at_cross_attn_queries=False, self_num_heads=1,
                 cross_num_heads=1, cross_kv_in_dim=64, rope_theta=10000.0,
                 rope_feat_sizes=(32, 32)):
        super().__init__()
        self.self_attn = RoPEAttention(
            d_model, self_num_heads, rope_theta=rope_theta,
            feat_sizes=rope_feat_sizes)
        self.cross_attn_image = RoPEAttention(
            d_model, cross_num_heads, kv_in_dim=cross_kv_in_dim,
            rope_theta=rope_theta, rope_k_repeat=True,
            feat_sizes=rope_feat_sizes)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.act = ACT[activation]
        self.pos_enc_at_attn = pos_enc_at_attn
        self.pos_enc_at_cross_attn_keys = pos_enc_at_cross_attn_keys
        self.pos_enc_at_cross_attn_queries = pos_enc_at_cross_attn_queries

    def forward(self, tgt, memory, pos=None, query_pos=None,
                num_k_exclude_rope=0, memory_valid=None):
        tgt2 = self.norm1(tgt)
        q = tgt2 + query_pos if self.pos_enc_at_attn else tgt2
        tgt = tgt + self.self_attn(q, q, tgt2)

        # the bank may be held in float32: keys add their position there,
        # then both sides enter the projections in the compute dtype
        tgt2 = self.norm2(tgt)
        qq = tgt2 + query_pos if self.pos_enc_at_cross_attn_queries else tgt2
        kk = memory + pos if self.pos_enc_at_cross_attn_keys else memory
        tgt = tgt + self.cross_attn_image(
            qq, kk.to(tgt.dtype), memory.to(tgt.dtype),
            num_k_exclude_rope=num_k_exclude_rope, key_valid=memory_valid)

        tgt2 = self.linear2(self.act(self.linear1(self.norm3(tgt))))
        return tgt + tgt2


class MemoryAttention(nn.Module):
    def __init__(self, d_model=256, num_layers=4, pos_enc_at_input=True,
                 layer_kwargs=None):
        super().__init__()
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(d_model=d_model, **(layer_kwargs or {}))
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model)
        self.pos_enc_at_input = pos_enc_at_input

    def forward(self, curr, curr_pos, memory, memory_pos,
                num_obj_ptr_tokens=0, memory_valid=None):
        output = curr
        if self.pos_enc_at_input and curr_pos is not None:
            output = output + 0.1 * curr_pos
        for layer in self.layers:
            output = layer(output, memory, pos=memory_pos, query_pos=curr_pos,
                           num_k_exclude_rope=num_obj_ptr_tokens,
                           memory_valid=memory_valid)
        return self.norm(output)
