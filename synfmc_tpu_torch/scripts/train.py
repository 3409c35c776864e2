"""Training command line, the port of scripts/train.py:

    python -m synfmc_tpu_torch.scripts.train --stage {lora,cam,obj} --config configs/<stage>.yaml \\
        [--max-steps N] [--device cpu]

    python -m torch.distributed.run --nproc-per-node N -m synfmc_tpu_torch.scripts.train \\
        --distributed --stage cam --config C   # the config's mesh: {data, fsdp, sp},
                                               # data x fsdp x sp = N

Runs ``training.trainers.train`` for the stage (1: image LoRA, 2: CMC, 3:
OMC) on the GPU unless ``--device cpu`` is given and prints the metrics dict
on its last line (with ``'preempted': True`` after a SIGTERM or SIGINT, which
stops the run cleanly after a final checkpoint).  ``--distributed`` (the JAX
flag) joins the process group of ``torch.distributed.run`` first: one
process a GPU, NCCL (gloo with ``--device cpu``); the config's ``mesh``
lays the ranks out (``mesh: {fsdp: 2}`` shards the fp32 masters and the
AdamW moments over 2 ranks that see the same samples).  A config whose mesh
is larger than 1 raises without it.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m synfmc_tpu_torch.scripts.train")
    p.add_argument("--stage", required=True, choices=["lora", "cam", "obj"])
    p.add_argument("--config", required=True)
    p.add_argument("--max-steps", type=int, default=None, help="override max_train_steps")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group of python -m torch.distributed.run; the "
                        "config's mesh: {data, fsdp, sp} lays out its ranks")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch.distributed as dist

    from synfmc_tpu_torch.training.trainers import train

    if args.distributed:
        from synfmc_tpu_torch.parallel.mesh import init_distributed

        init_distributed(device=args.device)  # None: cuda:LOCAL_RANK
    try:
        metrics = train(args.stage, args.config, max_steps=args.max_steps, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print({k: v for k, v in metrics.items()}, flush=True)


if __name__ == "__main__":
    main()
