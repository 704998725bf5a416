"""Record one episode of a policy as an upscaled GIF/MP4.

Twin of ``examples/record_video.py``::

    python -m tetris_gymnasium_torch.examples.record_video --out episode.gif --seed 3

With ``--checkpoint`` (an exported ``.npz``), ``--net`` and
``--frame-stack`` it plays that net greedily; otherwise the policy is
uniform random, drawing JAX's actions.  The episode runs on ``--device``
(the card by default); a frame there is four launches
(:mod:`tetris_gymnasium_torch.utils.video`).
"""
from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="episode.gif")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=300)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--upscale", type=int, default=10)
    p.add_argument("--checkpoint", default=None, help="exported .npz of flat parameters")
    p.add_argument("--net", choices=("qnet", "actor-critic"), default="qnet",
                   help="checkpoint family: DQN Q-net or PPO actor-critic")
    p.add_argument("--frame-stack", type=int, default=1,
                   help="K the checkpoint trained with; the episode feeds the net the "
                   "same [1, K, H, W] motion window")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="compute type of the conv trunk (the heads are float32)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Writes the episode; returns ``(frames, path)``."""
    import torch

    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.utils import video

    args = parse_args(argv)
    policy = None
    if args.checkpoint:
        from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic, load_q_net

        dtype = getattr(torch, args.dtype)
        net = load_actor_critic(args.checkpoint, device=args.device, dtype=dtype) \
            if args.net == "actor-critic" else \
            load_q_net(args.checkpoint, "q_cnn", device=args.device, dtype=dtype)
        policy = video.greedy_policy_fn(net, frame_stack=args.frame_stack)
    frames = video.record_episode(policy_fn=policy, config=EngineConfig(), seed=args.seed,
                                  max_steps=args.max_steps, upscale_factor=args.upscale,
                                  device=args.device)
    path = video.write_video(frames, args.out, fps=args.fps)
    print(f"wrote {len(frames)} frames to {path} ({frames.shape[1]}x{frames.shape[2]})")
    return frames, path


if __name__ == "__main__":
    main()
