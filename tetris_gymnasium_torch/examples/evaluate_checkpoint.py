"""Evaluate an exported checkpoint: N greedy episodes in lockstep on the card.

Twin of ``examples/evaluate_checkpoint.py``, with its flags and its output:
one JSON line of statistics, each rounded to 4 places as a float.  The
checkpoint is an exported ``.npz`` of flat parameters
(``tools/export_torch_params.py``, or a trainer's ``--save-params``): a
:class:`QNetworkCNN` (``--net qnet``, the default) or an actor-critic
(``--net actor-critic``, greedy over its policy logits).  ``--device`` and
``--dtype`` are the port's::

    python -m tetris_gymnasium_torch.examples.evaluate_checkpoint --net actor-critic \\
        --checkpoint results/ppo_lines_params.npz --episodes 512
    python -m tetris_gymnasium_torch.examples.evaluate_checkpoint --checkpoint q.npz \\
        --frame-stack 4 [--width 10 --height 20]
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True, help="exported .npz of flat parameters")
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=2000)
    p.add_argument("--frame-stack", type=int, default=1, help="K the net trained with")
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--impl", choices=("flagship", "turbo"), default="turbo",
                   help="rollout engine (board observations are value-equal on both)")
    p.add_argument("--net", choices=("qnet", "actor-critic"), default="qnet",
                   help="checkpoint family: DQN Q-net or PPO actor-critic (greedy = "
                   "argmax over policy logits)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="compute type of the conv trunk (the heads are float32)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from tetris_gymnasium_torch.rl.evaluate import evaluate_file

    args = parse_args(argv)
    stats = evaluate_file(
        args.checkpoint, "q" if args.net == "qnet" else "actor-critic", args.impl, "board",
        args.frame_stack, args.episodes, args.seed, args.max_steps, args.width, args.height,
        args.dtype, args.device,
    )
    out = {k: round(float(v), 4) for k, v in stats.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
