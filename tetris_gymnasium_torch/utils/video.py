"""Episode video capture: roll out a policy, write an upscaled RGB episode.

Port of ``tetris_gymnasium_tpu/utils/video.py:22-137``.  An episode is one
env (a batch of one) on the flagship engine, stepped with the board
observation; each frame is ``engine.render_rgb`` (board left, queue
top-right, holder bottom-right), upscaled on the host.  On the card a frame
launches ``flagship_step`` and ``flagship_observe_board`` (the step and the
policy's board), then ``observe_dict`` and ``compose_rgb`` (the frame); an
episode starts with one ``flagship_init``.

:func:`write_video` writes with imageio where it imports (GIF always, MP4
when an ffmpeg backend is present) and otherwise with :func:`write_gif`,
this module's own GIF89a writer (numpy and LZW), since the card's machine
has no imageio.  An MP4 asked for without a backend becomes a GIF, as in
JAX.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.utils.device import resolve_device


def upscale(frame: np.ndarray, factor: int) -> np.ndarray:
    """Nearest-neighbour upscale ``[H, W, C] -> [H*f, W*f, C]``: the values of
    the reference's ``np.kron`` trick, by two ``repeat``s (a quarter of its
    host time)."""
    return frame.repeat(factor, axis=0).repeat(factor, axis=1)


def _random_policy(obs: torch.Tensor, key: np.ndarray) -> int:
    """JAX's default policy: ``randint(key, (), 0, 8)``, a draw of shape ``()``."""
    return int(threefry.randint(key, 1, 8)[0])


def record_episode(
    policy_fn: Optional[Callable] = None,
    config: EngineConfig = EngineConfig(),
    seed: int = 0,
    max_steps: int = 500,
    upscale_factor: int = 10,
    device="cuda",
) -> np.ndarray:
    """Play one episode, return frames ``uint8[T, H*u, W*u, 3]``.

    ``policy_fn(obs int8[H, W] tensor, key uint32[2]) -> action`` defaults to
    uniform random.  The keys are JAX's: the env
    resets from ``fold_in(PRNGKey(seed), 0)`` and each step's policy key is
    the second half of ``split(key)``.
    """
    device = resolve_device(device)
    step = engine.jit_step(config, obs="board")
    render = engine.jit_render_rgb(config)
    key = threefry.prng_key(seed)
    state, obs = engine.jit_reset(config, obs="board", device=device)(
        threefry.fold_in(key, 0)[None])
    policy_fn = policy_fn or _random_policy

    def frame(s):
        return upscale(render(s)[0].cpu().numpy(), upscale_factor)

    frames = [frame(state)]
    for _ in range(max_steps):
        key, sub = threefry.split(key)
        action = policy_fn(obs[0], sub)
        state, obs, _, done, _ = step(state, torch.tensor([int(action)], dtype=torch.int32,
                                                          device=device))
        frames.append(frame(state))
        if bool(done[0]):
            break
    return np.stack(frames)


def greedy_policy_fn(net: torch.nn.Module, frame_stack: int = 1) -> Callable:
    """A :func:`record_episode` policy that plays ``net`` greedily.

    Actor-critics (``net(x) -> (logits, value)``) and Q-nets (``net(x) ->
    q``) both play.  With ``frame_stack`` K > 1 a host-side window feeds the
    net the ``[1, K, H, W]`` stack it trained on; the window starts full of
    the first frame (:mod:`tetris_gymnasium_torch.ops.framestack`).
    """
    window: list = []

    def policy(obs: torch.Tensor, key) -> int:
        if frame_stack > 1:
            if not window:
                window.extend([obs] * frame_stack)
            else:
                window.append(obs)
                del window[0]
            obs_in = torch.stack(window)[None]  # [1, K, H, W]
        else:
            obs_in = obs[None]
        with torch.inference_mode():
            out = net(obs_in)
        scores = out[0] if isinstance(out, tuple) else out
        return int(torch.argmax(scores, dim=-1)[0])

    return policy


def record_training_video(
    net: torch.nn.Module,
    path: str,
    config: EngineConfig = EngineConfig(),
    frame_stack: int = 1,
    seed: int = 0,
    max_steps: int = 400,
) -> str:
    """One greedy episode of ``net`` -> a GIF/MP4 at ``path``; returns the
    path written.  The episode runs on the net's device and draws from no
    key of the caller's: recording leaves a training run's streams as they
    were."""
    device = next(net.parameters()).device
    frames = record_episode(greedy_policy_fn(net, frame_stack), config=config, seed=seed,
                            max_steps=max_steps, device=device)
    return write_video(frames, path)


def write_video(frames: np.ndarray, path: str, fps: int = 10) -> str:
    """Write frames to ``path`` (.gif always; .mp4 if imageio has an ffmpeg
    backend); returns the path written, the ``.gif`` beside it when the
    mp4 backend is missing."""
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is None:
        if not path.endswith(".gif"):
            path = path.rsplit(".", 1)[0] + ".gif"
        write_gif(frames, path, fps=fps)
        return path
    try:
        imageio.mimsave(path, list(frames), fps=fps)
        return path
    except Exception:
        if path.endswith(".gif"):
            raise
        alt = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimsave(alt, list(frames), fps=fps)
        return alt


# ---------------------------------------------------------------------------
# GIF89a writer
# ---------------------------------------------------------------------------


def _lzw(indices: bytes, min_size: int) -> bytes:
    """GIF's variable-width LZW of the colour indices, as data sub-blocks."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width, next_code = min_size + 1, eoi + 1
    table: dict = {}
    out = bytearray()
    acc = n_bits = 0

    def emit(code):
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += width
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    emit(clear)
    prefix = indices[0]
    for b in indices[1:]:
        k = (prefix << 8) | b
        code = table.get(k)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[k] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:  # the table is full: start again
            emit(clear)
            table.clear()
            width, next_code = min_size + 1, eoi + 1
        prefix = b
    emit(prefix)
    emit(eoi)
    if n_bits:
        out.append(acc & 0xFF)
    blocks = bytearray([min_size])
    for i in range(0, len(out), 255):
        chunk = out[i : i + 255]
        blocks.append(len(chunk))
        blocks += chunk
    blocks.append(0)
    return bytes(blocks)


def write_gif(frames: np.ndarray, path: str, fps: int = 10) -> None:
    """Write ``uint8[T, H, W, 3]`` frames as a looping GIF89a, exactly.

    One global palette holds every colour of the episode (at most 256; the
    engine's frames hold a handful).  After the first frame each frame
    stores only the rectangle that changed since the one before, drawn over
    it (disposal 1), so a reader gives back the input frames.
    """
    frames = np.asarray(frames, dtype=np.uint8)
    T, H, W, _ = frames.shape
    packed = (frames[..., 0].astype(np.uint32) << 16) | (frames[..., 1].astype(np.uint32) << 8) \
        | frames[..., 2]
    colours = np.unique(packed)
    if len(colours) > 256:
        raise ValueError(f"{len(colours)} colours; a GIF palette holds 256")
    bits = max(1, int(len(colours) - 1).bit_length())
    palette = np.zeros((1 << bits, 3), dtype=np.uint8)
    palette[: len(colours)] = np.stack([colours >> 16, colours >> 8, colours], -1) & 0xFF
    index = np.searchsorted(colours, packed).astype(np.uint8)  # [T, H, W]
    min_size = max(2, bits)
    delay = max(1, round(100 / fps))
    out = bytearray(b"GIF89a")
    out += np.array([W, H], dtype="<u2").tobytes() + bytes([0xF0 | (bits - 1), 0, 0])
    out += palette.tobytes()
    out += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    prev = None
    for t in range(T):
        img = index[t]
        if prev is None:
            top, left, bottom, right = 0, 0, H, W
        else:
            changed = img != prev
            rows, cols = np.flatnonzero(changed.any(1)), np.flatnonzero(changed.any(0))
            if len(rows):
                top, bottom, left, right = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
            else:  # an unchanged frame: redraw one pixel
                top, bottom, left, right = 0, 1, 0, 1
        prev = img
        out += b"\x21\xF9\x04\x04" + np.array([delay], dtype="<u2").tobytes() + b"\x00\x00"
        out += b"\x2C" + np.array([left, top, right - left, bottom - top], dtype="<u2").tobytes() \
            + b"\x00"
        out += _lzw(img[top:bottom, left:right].tobytes(), min_size)
    out += b"\x3B"
    with open(path, "wb") as f:
        f.write(out)
