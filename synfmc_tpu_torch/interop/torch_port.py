"""Load JAX parameter trees into the port's modules.

The JAX package's params are nested dicts of arrays whose paths map to the
reference's diffusers-style state-dict names by the rule tables below (this
package's own copy of synfmc_tpu/interop/torch_port.py's rules); leaves are
transposed HWIO -> OIHW (conv) and (in, out) -> (out, in) (Dense).  The
port's modules use those names, so ``load_state_dict(strict=True)`` both
loads and checks the weights.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
_CONTAINERS = (
    "down_blocks|up_blocks|resnets|attentions|motion_modules|transformer_blocks"
    "|attention_blocks|norms|blocks|downsamplers|upsamplers|layers|body|net"
)
_CONTAINER_RULE = (rf"\b({_CONTAINERS})_(\d+)", r"\1.\2")


def _apply_rules(path: str, rules) -> str:
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    return path


def _name(path: str, leaf: str) -> str:
    return path.replace("/", ".") + "." + _LEAF_TO_TORCH[leaf]


def unet_path_to_torch(parts: tuple[str, ...]) -> str:
    leaf, path = parts[-1], "/".join(parts[:-1])
    rules = [
        (r"\bnet_0_proj\b", "net_0/proj"),
        _CONTAINER_RULE,
        (r"/blocks\.(\d+)", r"/transformer_blocks.\1"),
        (r"(motion_modules\.\d+)/", r"\1/temporal_transformer/"),
        (r"/(to_(?:q|k|v|out)_lora)(/|$)", r"/processor/\1\2"),
        (r"/(qkv_merge|q_merge|kv_merge)$", r"/processor/\1"),
        (r"/to_out$", "/to_out/0"),
    ]
    return _name(_apply_rules(path, rules), leaf)


def vae_path_to_torch(parts: tuple[str, ...]) -> str:
    leaf, path = parts[-1], "/".join(parts[:-1])
    rules = [
        (r"(\d)_(resnets|downsamplers|upsamplers)", r"\1/\2"),
        _CONTAINER_RULE,
        (r"/to_out$", "/to_out/0"),
    ]
    return _name(_apply_rules(path, rules), leaf)


def clip_path_to_torch(parts: tuple[str, ...]) -> str:
    if parts == ("position_embedding",):
        return "text_model.embeddings.position_embedding.weight"
    leaf, path = parts[-1], "/".join(parts[:-1])
    rules = [
        _CONTAINER_RULE,
        (r"^layers\.", "encoder/layers."),
        (r"/mlp_fc(\d)", r"/mlp/fc\1"),
        (r"^token_embedding$", "embeddings/token_embedding"),
    ]
    return "text_model." + _name(_apply_rules(path, rules), leaf)


def pose_encoder_path_to_torch(parts: tuple[str, ...]) -> str:
    leaf, path = parts[-1], "/".join(parts[:-1])
    m = re.match(r"^blocks_(\d+)_(\d+)_(conv|attn)(/.*)?$", path)
    if m:
        i, j, kind, rest = m.groups()
        base = "encoder_down_conv_blocks" if kind == "conv" else "encoder_down_attention_blocks"
        path = f"{base}.{i}.{j}{rest or ''}"
    elif path.startswith("conv_in"):
        path = path.replace("conv_in", "encoder_conv_in", 1)
    rules = [
        (r"\bnet_0_proj\b", "net_0/proj"),
        _CONTAINER_RULE,
        (r"/to_out$", "/to_out/0"),
    ]
    return _name(_apply_rules(path, rules), leaf)


def adapter_path_to_torch(parts: tuple[str, ...]) -> str:
    leaf, path = parts[-1], "/".join(parts[:-1])
    rules = [
        (r"^zero_conv_out_(\d+)", r"zero_conv_out_list.\1"),
        _CONTAINER_RULE,
    ]
    return _name(_apply_rules(path, rules), leaf)


CONVERTERS: dict[str, Callable[[tuple[str, ...]], str]] = {
    "unet": unet_path_to_torch,
    "vae": vae_path_to_torch,
    "clip_text": clip_path_to_torch,
    "pose_encoder": pose_encoder_path_to_torch,
    "adapter": adapter_path_to_torch,
}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _to_torch_layout(t: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel":
        if t.ndim == 4:  # HWIO -> OIHW
            return t.transpose(3, 2, 0, 1)
        if t.ndim == 2:  # (in, out) -> (out, in)
            return t.T
    return t


def jax_state_dict(params: Mapping, kind: str) -> dict[str, np.ndarray]:
    """JAX param tree (optionally wrapped as {'params': ...}) -> torch-named arrays."""
    if set(params) == {"params"}:
        params = params["params"]
    conv = CONVERTERS[kind]
    return {conv(key): np.ascontiguousarray(_to_torch_layout(np.asarray(v, np.float32), key[-1]))
            for key, v in _flatten(params).items()}


def load_jax_params(module: torch.nn.Module, params: Mapping, kind: str) -> torch.nn.Module:
    """Copy a JAX param tree into ``module`` with ``load_state_dict(strict=True)``;
    tensors take the module's own dtype, device and memory format."""
    sd = {k: torch.tensor(v) for k, v in jax_state_dict(params, kind).items()}
    module.load_state_dict(sd, strict=True)
    return module
