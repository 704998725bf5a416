"""Device replay buffer: a struct of arrays written and sampled on the card.

Port of ``tetris_gymnasium_tpu/rl/buffers.py`` (``ReplayBuffer :22``,
``create :30``, ``add :46``, ``sample :64``, ``sample_with_next :70``,
``sample_with_next_stacked :111``).
Each field has one ``[capacity, ...]`` store; an add writes one env batch
as a contiguous block (the capacity is a multiple of the batch), and a
sample gathers random entries, the offsets drawn with JAX's
``randint`` from a host key.

Two things differ from JAX:

* the stores are written in place (no second copy of the buffer); :func:`add`
  returns the buffer with the new write position and size, sharing them;
* ``pos`` and ``size`` are Python ints: one add per step fixes both, so the
  host knows them exactly, and no draw or bound waits for the card.

Each entry point dispatches on the stores' device: on CUDA the
``replay_add``, ``replay_sample`` and ``replay_sample_stacked`` kernels of
:mod:`tetris_gymnasium_torch.kernels` run (one launch for every field), on
the CPU the plain versions below (:func:`add_plain`, :func:`sample_plain`,
:func:`sample_with_next_plain`, :func:`sample_with_next_stacked_plain`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from tetris_gymnasium_torch.ops import threefry


@dataclasses.dataclass
class ReplayBuffer:
    """Circular struct-of-arrays buffer."""

    data: Dict[str, torch.Tensor]  # field -> [capacity, ...]
    pos: int = 0  # next write offset, a multiple of the batch
    size: int = 0  # valid entries

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[0]


def create(example: Dict[str, torch.Tensor], capacity: int, batch: int) -> ReplayBuffer:
    """Zeroed stores shaped after one batched transition ``{field: [batch, ...]}``,
    on the example's device; ``capacity`` must be a multiple of ``batch``."""
    if capacity % batch != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of batch {batch}")
    data = {k: torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            for k, x in example.items()}
    return ReplayBuffer(data=data, pos=0, size=0)


def _advance(buffer: ReplayBuffer, batch: int) -> ReplayBuffer:
    cap = buffer.capacity
    return ReplayBuffer(data=buffer.data, pos=(buffer.pos + batch) % cap,
                        size=min(buffer.size + batch, cap))


def add_plain(buffer: ReplayBuffer, transitions: Dict[str, torch.Tensor]) -> ReplayBuffer:
    """Plain version of :func:`add`, on any device."""
    batch = next(iter(transitions.values())).shape[0]
    for k, store in buffer.data.items():
        store[buffer.pos : buffer.pos + batch] = transitions[k].to(store.dtype)
    return _advance(buffer, batch)


def add(buffer: ReplayBuffer, transitions: Dict[str, torch.Tensor]) -> ReplayBuffer:
    """Write one env batch ``{field: [batch, ...]}`` at ``pos``, in place.

    On CUDA stores the ``replay_add`` kernel writes every field in one
    launch; a field may then be a ``[batch, n]`` transposed view of a
    batch-minor tensor (the engine's mask), and must have its store's dtype.
    """
    if next(iter(buffer.data.values())).is_cuda:
        from tetris_gymnasium_torch import kernels

        batch = next(iter(transitions.values())).shape[0]
        kernels.replay_add(buffer.data, transitions, buffer.pos)
        return _advance(buffer, batch)
    return add_plain(buffer, transitions)


def _gather(buffer: ReplayBuffer, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: x.index_select(0, idx) for k, x in buffer.data.items()}


def sample_plain(buffer: ReplayBuffer, key, batch_size: int) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`sample`, on any device."""
    dev = next(iter(buffer.data.values())).device
    return _gather(buffer, threefry.randint_lanes(key, batch_size, max(buffer.size, 1), dev))


def sample(buffer: ReplayBuffer, key, batch_size: int) -> Dict[str, torch.Tensor]:
    """``batch_size`` uniform entries, ``randint(key, (batch_size,), 0, max(size, 1))``."""
    if next(iter(buffer.data.values())).is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.replay_sample(buffer.data, key, batch_size, max(buffer.size, 1))[0]
    return sample_plain(buffer, key, batch_size)


def _successor_window(buffer: ReplayBuffer, batch: int):
    """``(start, n_valid)``: the oldest entry and how many entries have a
    successor in the buffer (``buffers.py:90-101``)."""
    if buffer.capacity < 2 * batch:
        # with a single block, the "successor" of an entry is itself
        raise ValueError(f"sample_with_next needs capacity >= 2*batch "
                         f"(got {buffer.capacity} < 2*{batch})")
    start = buffer.pos if buffer.size == buffer.capacity else 0
    # callers must not sample before two blocks are resident (size > batch);
    # the max(1) only keeps randint's bound legal
    return start, max(buffer.size - batch, 1)


def sample_with_next_plain(buffer: ReplayBuffer, key, batch_size: int, batch: int):
    """Plain version of :func:`sample_with_next`, on any device."""
    start, n_valid = _successor_window(buffer, batch)
    dev = next(iter(buffer.data.values())).device
    off = threefry.randint_lanes(key, batch_size, n_valid, dev)
    idx = (start + off) % buffer.capacity
    nxt = (idx + batch) % buffer.capacity
    return _gather(buffer, idx), _gather(buffer, nxt)


def sample_with_next(buffer: ReplayBuffer, key, batch_size: int, batch: int):
    """Uniform entries and their successors (the same env one step later).

    Entry ``i``'s next observation is entry ``i + batch``'s, so the buffer
    stores every observation once; the newest block, whose successors are
    not written yet, is never drawn.  Returns ``(transitions,
    next_transitions)``, each ``{field: [batch_size, ...]}``.  On CUDA
    stores one ``replay_sample`` launch draws the offsets and gathers both.
    """
    if next(iter(buffer.data.values())).is_cuda:
        from tetris_gymnasium_torch import kernels

        start, n_valid = _successor_window(buffer, batch)
        return kernels.replay_sample(buffer.data, key, batch_size, n_valid, start=start, batch=batch)
    return sample_with_next_plain(buffer, key, batch_size, batch)


def _stacked_window(buffer: ReplayBuffer, batch: int, k: int):
    """``(start, n_valid)`` of :func:`sample_with_next_stacked` (``buffers.py:139-147``)."""
    if buffer.capacity < (k + 1) * batch:
        raise ValueError(f"sample_with_next_stacked needs capacity >= (k+1)*batch "
                         f"(got {buffer.capacity} < {(k + 1) * batch})")
    start = buffer.pos if buffer.size == buffer.capacity else 0
    return start, max(buffer.size - k * batch, 1)


def stacked_sample_rows(buffer: ReplayBuffer, key, batch_size: int, batch: int, k: int,
                        done_key: str = "done"):
    """The entries that :func:`sample_with_next_stacked` gathers:
    ``(anchors, windows, depth)``.  ``anchors`` ``[2, batch_size]`` are the
    sampled entries and their successors; ``windows`` ``[2, batch_size, k]``
    the entries of each anchor's window, oldest first; ``depth``
    ``[2, batch_size]`` its lookback depth ``m``, the done flags of
    transitions ``t-1 .. t-m`` being clear and the next (if any) set."""
    start, n_valid = _stacked_window(buffer, batch, k)
    cap = buffer.capacity
    done_store = buffer.data[done_key]
    dev = done_store.device
    off = (k - 1) * batch + threefry.randint_lanes(key, batch_size, n_valid, dev)
    idx = (start + off) % cap
    anchors = torch.stack([idx, (idx + batch) % cap])
    js = torch.arange(k, dtype=torch.int64, device=dev)  # lookback depth, newest first
    # d[..., j-1] is the done flag of transition t-j; a set flag means every
    # deeper frame belongs to a previous episode
    d = done_store[(anchors[..., None] - js[1:] * batch) % cap].to(torch.int64)
    depth = (torch.cumsum(d, dim=-1) == 0).sum(dim=-1)
    windows = (anchors[..., None] - torch.minimum(js, depth[..., None]) * batch) % cap
    return anchors, windows.flip(-1), depth  # newest first -> oldest first


def sample_with_next_stacked_plain(buffer: ReplayBuffer, key, batch_size: int, batch: int, k: int,
                                   obs_key: str = "obs", done_key: str = "done"):
    """Plain version of :func:`sample_with_next_stacked`, on any device."""
    anchors, windows, _ = stacked_sample_rows(buffer, key, batch_size, batch, k, done_key)
    cur, nxt = _gather(buffer, anchors[0]), _gather(buffer, anchors[1])
    obs_store = buffer.data[obs_key]
    cur[obs_key], nxt[obs_key] = obs_store[windows[0]], obs_store[windows[1]]
    return cur, nxt


def sample_with_next_stacked(buffer: ReplayBuffer, key, batch_size: int, batch: int, k: int,
                             obs_key: str = "obs", done_key: str = "done"):
    """:func:`sample_with_next` whose observations come back as K-frame
    windows ``[batch_size, K, ...]``, rebuilt from the single stored frames.

    The same env's previous frame is ``batch`` entries earlier, so the
    window the actor saw at a transition is gathered at sample time: frame
    ``j`` back (newest first) belongs to the episode unless a ``done``
    fired in transitions ``t-j .. t-1``, and deeper slots repeat the
    episode's first frame (:mod:`~tetris_gymnasium_torch.ops.framestack`
    semantics, oldest first).  The oldest ``k - 1`` blocks are never drawn,
    so every lookback is resident: callers sample only once ``k + 1``
    blocks are in the buffer.  On CUDA stores one ``replay_sample_stacked``
    launch draws the offsets and gathers everything.
    """
    if next(iter(buffer.data.values())).is_cuda:
        from tetris_gymnasium_torch import kernels

        start, n_valid = _stacked_window(buffer, batch, k)
        return kernels.replay_sample_stacked(buffer.data, key, batch_size, n_valid, start, batch, k,
                                             obs_key=obs_key, done_key=done_key)
    return sample_with_next_stacked_plain(buffer, key, batch_size, batch, k, obs_key, done_key)
