"""Reading the reference's torch checkpoint bundles into the port's modules.

The reader half of synfmc_tpu/training/checkpoint.py: ``torch_load_state_dict``
(:167) and ``load_into_params`` (:299) as ``load_into_module``.  The port's
modules carry the reference's state-dict names, so a bundle's tensors load
by name; the checks are the JAX package's: every checkpoint key must land
in the module, shapes must agree, and a strict load must cover the module.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch

# Checkpoint keys with no parameter behind them (synfmc_tpu/interop/
# torch_port.py:185): AnimateDiff's temporal PE table, BatchNorm counters and
# CLIP's position ids.  The port's temporal PE is a non-persistent buffer
# named ``...attention_blocks.N.pe``, so ``...pos_encoder.pe`` never matches
# a key of the module and is dropped before loading.
IGNORABLE = re.compile(r"(pos_encoder\.pe|num_batches_tracked|position_ids)$")


def torch_load_state_dict(path: str) -> dict:
    """A torch checkpoint (a state dict or a bundle of them) on the CPU.
    Full unpickling, as the JAX package does: load only trusted files."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_into_module(module: torch.nn.Module, state_dict: Mapping, kind: str,
                     strict: bool = False) -> torch.nn.Module:
    """Copy ``state_dict``'s tensors into ``module`` (its dtype, device and
    memory format kept).  Raises ValueError on a shape mismatch,
    AssertionError when a checkpoint key (other than ``IGNORABLE`` ones) has
    no place in the module, and with ``strict`` KeyError when a module key
    has no tensor in the checkpoint."""
    own = module.state_dict()
    tensors, unused = {}, []
    for name, value in state_dict.items():
        if IGNORABLE.search(name):
            continue
        if name not in own:
            unused.append(name)
            continue
        t = torch.as_tensor(value)
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch {name}: checkpoint {tuple(t.shape)} vs "
                             f"{kind} {tuple(own[name].shape)}")
        tensors[name] = t
    if unused:
        raise AssertionError(f"unconsumed {kind} checkpoint keys: {unused[:5]}")
    missing = [k for k in own if k not in tensors]
    if strict and missing:
        raise KeyError(f"missing checkpoint tensors for {len(missing)} {kind} keys, "
                       f"e.g. {missing[:5]}")
    module.load_state_dict(tensors, strict=False)
    return module
