"""The CUDA kernels as ``torch.library`` custom ops in the ``synfmc`` namespace.

Five ops, each defined by the module of its kernel:

- ``synfmc::flash_attention_fwd`` (K1, K4) and ``synfmc::flash_attention_bwd``
  (K5-K7), ``ops/flash_attention.py``;
- ``synfmc::temporal_attention_fwd`` (K2) and ``synfmc::temporal_attention_bwd``
  (K8), ``ops/temporal_attention.py``;
- ``synfmc::fused_group_norm_fwd`` (K3), ``ops/fused_groupnorm.py``.

Each has three implementations: ``cuda`` (the kernel's launch code: every
``data_ptr()``, alignment check, plan and C entry sits there), ``cpu`` (the
plain version) and a fake one (shapes and dtypes only).  ``torch.export``
traces through the fakes and records the ops as calls of
``torch.ops.synfmc.*``; a program loaded with ``torch.export.load`` calls them
again, so the process that loads one imports ``synfmc_tpu_torch.ops`` first
(importing the package registers the ops).

The wrappers reach an op through :func:`call`.  Outside a trace it runs the
implementation of the tensor's device directly: the dispatcher's route costs
host time on every launch (``chip_smoke.py``'s main phase prints it against a
denoise step), and a wrapper decides its route from ``tensor.device`` alone.
Inside a trace (``torch.export``, ``torch.compile``) it calls the op, so the
graph holds it.  Either way there is one implementation per device.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "synfmc"

# name -> {device type: implementation}
IMPLS: dict[str, dict[str, Callable]] = {}


def tracing() -> bool:
    """Whether the caller runs inside a torch.export or torch.compile trace."""
    return torch.compiler.is_compiling()


def define(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Register ``synfmc::<name>`` with its three implementations."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    IMPLS[name] = {"cpu": cpu, "cuda": cuda}
    return op


def op(name: str):
    """The registered op ``torch.ops.synfmc.<name>``."""
    return getattr(getattr(torch.ops, NAMESPACE), name)


def call(name: str, *args):
    """Run ``synfmc::<name>``: through the op inside a trace, else the
    implementation of the first tensor's device."""
    if tracing():
        return op(name)(*args)
    impl = IMPLS[name].get(args[0].device.type)
    if impl is None:
        raise ValueError(f"{NAMESPACE}::{name}: no implementation on {args[0].device}")
    return impl(*args)


def counts(t: torch.Tensor) -> bool:
    """Whether a wrapper's call on ``t`` launched its kernel eagerly (a CUDA
    tensor outside a trace): the launch counters count those alone."""
    return t.device.type == "cuda" and not tracing()
