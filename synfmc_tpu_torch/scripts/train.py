"""Training command line, the port of scripts/train.py:

    python -m synfmc_tpu_torch.scripts.train --stage {lora,cam,obj} --config configs/<stage>.yaml \\
        [--max-steps N] [--device cpu]

Runs ``training.trainers.train`` for the stage (1: image LoRA, 2: CMC, 3:
OMC) on the GPU unless ``--device cpu`` is given and prints the metrics dict
on its last line (with ``'preempted': True`` after a SIGTERM or SIGINT, which
stops the run cleanly after a final checkpoint).
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
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from synfmc_tpu_torch.training.trainers import train

    metrics = train(args.stage, args.config, max_steps=args.max_steps, device=args.device)
    print({k: v for k, v in metrics.items()}, flush=True)


if __name__ == "__main__":
    main()
