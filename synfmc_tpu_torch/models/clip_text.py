"""CLIP ViT-L/14 text encoder (SD1.5 text conditioning), HF transformers names.

vocab 49408, hidden 768, 12 layers, 12 heads, 77 positions, quick_gelu MLP,
additive causal mask (-1e9), final LayerNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from synfmc_tpu_torch.models.layers import LayerNorm
from synfmc_tpu_torch.ops.attention import dot_product_attention

MAX_POSITIONS = 77


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, mask):
        b, s, c = x.shape
        d = c // self.heads
        q = self.q_proj(x).reshape(b, s, self.heads, d)
        k = self.k_proj(x).reshape(b, s, self.heads, d)
        v = self.v_proj(x).reshape(b, s, self.heads, d)
        out = dot_product_attention(q, k, v, scale=d ** -0.5, mask=mask)
        return self.out_proj(out.reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(hidden, hidden * ratio)
        self.fc2 = nn.Linear(hidden * ratio, hidden)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = LayerNorm(hidden)
        self.mlp = CLIPMLP(hidden)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden)
        self.position_embedding = nn.Embedding(MAX_POSITIONS, hidden)


class _Encoder(nn.Module):
    def __init__(self, hidden: int, num_layers: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(hidden, heads) for _ in range(num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, vocab_size, hidden, num_layers, heads):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden)
        self.encoder = _Encoder(hidden, num_layers, heads)
        self.final_layer_norm = LayerNorm(hidden)


class CLIPTextModel(nn.Module):
    def __init__(self, vocab_size: int = 49408, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12):
        super().__init__()
        self.text_model = _TextTransformer(vocab_size, hidden_size, num_layers, num_heads)

    def forward(self, input_ids) -> torch.Tensor:
        """(B, S) token ids -> (B, S, hidden) last_hidden_state."""
        tm = self.text_model
        b, s = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids.long()) + tm.embeddings.position_embedding.weight[None, :s]
        causal = torch.triu(torch.full((s, s), -1e9, dtype=torch.float32,
                                       device=input_ids.device), diagonal=1)[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)
