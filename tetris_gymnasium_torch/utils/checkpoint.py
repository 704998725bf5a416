"""Checkpoints: network weights as flat ``.npz`` files, and whole state trees.

**Whole state trees** (:func:`save`, :func:`restore`; ``tetris_gymnasium_tpu/
utils/checkpoint.py:33-59``).  Any training state (the env batch, the
network, the optimizer, the keys, the replay buffer) is one tree, saved to
a directory and restored into a template of the same structure, so a run
resumes where it stopped.  The directory holds ``leaves.npz`` (one array a
leaf, uncompressed) and ``tree.json`` (the structure, each leaf's dtype and
shape).  Nothing is pickled.  The format is the port's own: the JAX package
writes orbax directories, or a fallback whose structure is a pickled JAX
treedef, and the port reads neither (it has no JAX);
``tools/export_torch_params.py`` remains the bridge for weights.

**Network weights** (the functions below :func:`restore`).  The JAX package
saves parameters as an orbax directory, which this port cannot read without
JAX.  ``tools/export_torch_params.py`` turns one into a
plain ``.npz`` of the flat Flax parameter paths
(``results/ppo_lines_params.npz`` for the committed PPO policy); this module
reads that file, and writes the same format for a network the port trained:
the actor-critics (:class:`ActorCriticCNN`, :class:`AtariActorCritic`), the
grouped DQN's :class:`QMLP` and
:class:`QGroupedBoardsCNN`, and the DQN's :class:`QNetworkCNN` and
:class:`AtariQNetwork`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Union

import numpy as np
import torch

from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.networks import (
    ActorCriticCNN, AtariActorCritic, AtariQNetwork, QGroupedBoardsCNN, QMLP, QNetworkCNN,
)
from tetris_gymnasium_torch.utils.device import resolve_device

# -- whole state trees ---------------------------------------------------------------
#
# A tree is nested dicts, lists, tuples, named tuples and dataclasses; its
# leaves are tensors, numpy arrays and numpy or Python scalars (None, bool,
# int, float, str).  An ``nn.Module`` is saved as its ``state_dict()``, a
# ``torch.Generator`` as its ``get_state()``, and any other object with
# ``state_dict()`` and ``load_state_dict()`` (``torch.optim.Adam``, PPO's
# ``ClippedAdam``) as its state dict; these are restored into the
# template's own object.

TREE_FILE, LEAVES_FILE = "tree.json", "leaves.npz"

# tensor dtypes numpy lacks or PyTorch cannot hand to numpy on every build:
# stored as the unsigned integers of the same width (their bits), with the
# tensor dtype written in the structure
_BITS = {
    torch.bfloat16: (torch.int16, np.uint16),
    torch.uint16: (torch.int16, np.uint16),
    torch.uint32: (torch.int32, np.uint32),
    torch.uint64: (torch.int64, np.uint64),
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's values as numpy (bits for the dtypes of ``_BITS``)."""
    if t.dtype in _BITS:
        signed, unsigned = _BITS[t.dtype]
        return t.view(signed).numpy().view(unsigned)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_to_numpy`: a host tensor of ``dtype``."""
    a = a if a.flags.c_contiguous else a.copy()  # (ascontiguousarray makes 0-d arrays 1-d)
    if dtype in _BITS:
        signed, unsigned = _BITS[dtype]
        return torch.from_numpy(a.view(unsigned).view(_dtype_name(signed))).view(dtype)
    return torch.from_numpy(a)


def _stateful_kind(node) -> str:
    """How an object node is saved: ``"module"``, ``"generator"``,
    ``"stateful"`` (any other object with ``state_dict`` and
    ``load_state_dict``), or ``""`` for none of these."""
    if isinstance(node, torch.nn.Module):
        return "module"
    if isinstance(node, torch.Generator):
        return "generator"
    if callable(getattr(node, "state_dict", None)) and callable(
            getattr(node, "load_state_dict", None)):
        return "stateful"
    return ""


def _encode(node, path: str, leaves: List) -> Any:
    """The JSON structure of ``node``; its array leaves are appended to ``leaves``."""
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        return {"tensor": _dtype_name(node.dtype), "shape": list(node.shape), "leaf": len(leaves) - 1}
    if isinstance(node, (np.ndarray, np.generic)):
        a = np.asarray(node)
        if a.dtype == object:
            raise TypeError(f"{path}: object arrays cannot be saved")
        leaves.append(a)
        return {"array": a.dtype.str, "shape": list(a.shape), "leaf": len(leaves) - 1,
                "scalar": isinstance(node, np.generic)}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    kind = _stateful_kind(node)
    if kind:
        state = node.get_state() if kind == "generator" else node.state_dict()
        return {kind: _encode(state, path, leaves)}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {"dataclass": type(node).__name__,
                "fields": {f.name: _encode(getattr(node, f.name), f"{path}.{f.name}", leaves)
                           for f in dataclasses.fields(node)}}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {"namedtuple": type(node).__name__,
                "fields": {k: _encode(v, f"{path}.{k}", leaves) for k, v in node._asdict().items()}}
    if isinstance(node, dict):
        items = []
        for k, v in node.items():
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"{path}: dict key {k!r} is neither a str nor an int")
            items.append([k, type(k).__name__, _encode(v, f"{path}[{k!r}]", leaves)])
        return {"dict": items}
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [_encode(v, f"{path}[{i}]", leaves) for i, v in enumerate(node)]}
    raise TypeError(f"{path}: cannot save a {type(node).__name__}")


def save(path: str, tree: Any) -> None:
    """Save ``tree`` to the directory ``path`` (made, or overwritten).

    The leaves on the card come to the host through pinned buffers, all
    copies queued first and then one ``torch.cuda.synchronize()``.
    """
    leaves: List = []
    spec = _encode(tree, "tree", leaves)
    host = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            buf.copy_(leaf, non_blocking=True)
            host.append(buf)
        else:
            host.append(leaf.detach().contiguous() if isinstance(leaf, torch.Tensor) else leaf)
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda for leaf in leaves):
        torch.cuda.synchronize()
    os.makedirs(path, exist_ok=True)
    arrays = {str(i): _to_numpy(h) if isinstance(h, torch.Tensor) else h for i, h in enumerate(host)}
    np.savez(os.path.join(path, LEAVES_FILE), **arrays)
    with open(os.path.join(path, TREE_FILE), "w") as f:
        json.dump(spec, f)


class _Loader:
    """Rebuilds a tree from its saved structure and leaves."""

    def __init__(self, arrays):
        self.arrays = arrays
        self.pending = []  # pinned host buffers of queued copies to the card

    def leaf(self, spec) -> np.ndarray:
        return self.arrays[str(spec["leaf"])]

    def tensor(self, spec, dtype=None, device=None) -> torch.Tensor:
        t = _from_numpy(self.leaf(spec), getattr(torch, spec["tensor"]))
        if dtype is not None:
            t = t.to(dtype)
        if device is not None and device.type == "cuda":
            t = t.pin_memory()
            self.pending.append(t)
            return t.to(device, non_blocking=True)
        return t if device is None else t.to(device)

    def free(self, spec, path: str):
        """The saved node as it was written, leaves on the host."""
        if "tensor" in spec:
            return self.tensor(spec)
        if "array" in spec:
            a = self.leaf(spec).astype(np.dtype(spec["array"]), copy=False)
            return a[()] if spec.get("scalar") else a
        if "value" in spec:
            return spec["value"]
        if "dict" in spec:
            return {(int(k) if kt == "int" else k): self.free(v, f"{path}[{k!r}]")
                    for k, kt, v in spec["dict"]}
        for seq in ("list", "tuple"):
            if seq in spec:
                out = [self.free(v, f"{path}[{i}]") for i, v in enumerate(spec[seq])]
                return tuple(out) if seq == "tuple" else out
        raise ValueError(f"{path}: a saved {next(iter(spec))} needs a template to restore into")

    def like(self, spec, example, path: str):
        """The saved node in the structure, dtypes and devices of ``example``."""

        def expect(key, what):
            if key not in spec:
                raise ValueError(f"{path}: the template holds {what}, the checkpoint "
                                 f"{next(iter(spec))!r}")

        if isinstance(example, torch.Tensor):
            expect("tensor", "a tensor")
            if list(example.shape) != spec["shape"]:
                raise ValueError(f"{path}: saved shape {spec['shape']}, template "
                                 f"{list(example.shape)}")
            return self.tensor(spec, example.dtype, example.device)
        if isinstance(example, (np.ndarray, np.generic)):
            expect("array", "a numpy array")
            if list(np.shape(example)) != spec["shape"]:
                raise ValueError(f"{path}: saved shape {spec['shape']}, template "
                                 f"{list(np.shape(example))}")
            a = self.leaf(spec).astype(example.dtype)
            return example.dtype.type(a[()]) if isinstance(example, np.generic) else a
        if example is None or isinstance(example, (bool, int, float, str)):
            expect("value", f"a {type(example).__name__}")
            return spec["value"]
        kind = _stateful_kind(example)
        if kind:
            expect(kind, f"a {kind}")
            try:
                if kind == "module":
                    example.load_state_dict(self.like(spec[kind], example.state_dict(), path))
                elif kind == "generator":
                    example.set_state(self.like(spec[kind], example.get_state(), path))
                else:
                    example.load_state_dict(self.free(spec[kind], path))
            except (KeyError, RuntimeError, TypeError) as e:
                raise ValueError(f"{path}: {e}") from e
            return example
        if dataclasses.is_dataclass(example) and not isinstance(example, type):
            expect("dataclass", f"a {type(example).__name__}")
            names = [f.name for f in dataclasses.fields(example)]
            if list(spec["fields"]) != names:
                raise ValueError(f"{path}: saved fields {list(spec['fields'])}, template {names}")
            return dataclasses.replace(example, **{
                k: self.like(spec["fields"][k], getattr(example, k), f"{path}.{k}") for k in names})
        if isinstance(example, tuple) and hasattr(example, "_fields"):
            expect("namedtuple", f"a {type(example).__name__}")
            if list(spec["fields"]) != list(example._fields):
                raise ValueError(f"{path}: saved fields {list(spec['fields'])}, template "
                                 f"{list(example._fields)}")
            return type(example)(*(self.like(spec["fields"][k], v, f"{path}.{k}")
                                   for k, v in example._asdict().items()))
        if isinstance(example, dict):
            expect("dict", "a dict")
            saved = {(int(k) if kt == "int" else k): v for k, kt, v in spec["dict"]}
            if list(saved) != list(example):
                raise ValueError(f"{path}: saved keys {list(saved)}, template {list(example)}")
            return {k: self.like(saved[k], v, f"{path}[{k!r}]") for k, v in example.items()}
        if isinstance(example, (list, tuple)):
            seq = type(example).__name__
            expect(seq, f"a {seq}")
            if len(spec[seq]) != len(example):
                raise ValueError(f"{path}: saved length {len(spec[seq])}, template {len(example)}")
            out = [self.like(s, v, f"{path}[{i}]") for i, (s, v) in enumerate(zip(spec[seq], example))]
            return tuple(out) if seq == "tuple" else out
        raise TypeError(f"{path}: cannot restore into a {type(example).__name__}")


def restore(path: str, example: Any) -> Any:
    """The tree saved at ``path``, in the structure, dtypes and devices of ``example``.

    ``example`` is a template such as a freshly initialised state.  Raises
    ``ValueError`` naming the path in the tree where the saved structure or
    a shape differs from it.  Tensors and arrays come back as new objects;
    modules, optimizers and generators of ``example`` are loaded in place
    and returned.  The copies to the card go through pinned buffers and end
    in one ``torch.cuda.synchronize()``.
    """
    with open(os.path.join(path, TREE_FILE)) as f:
        spec = json.load(f)
    with np.load(os.path.join(path, LEAVES_FILE)) as data:
        loader = _Loader({k: data[k] for k in data.files})
    out = loader.like(spec, example, "tree")
    if loader.pending:
        torch.cuda.synchronize()
    return out


# -- network weights ------------------------------------------------------------------


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{flax/path: array}`` dict of an exported ``.npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def actor_critic_kind(net) -> str:
    """The converter's kind of an actor-critic (``models/convert.py``)."""
    return "atari_actor_critic" if isinstance(net, AtariActorCritic) else "actor_critic"


def flat_actor_critic_kind(flat: Dict[str, np.ndarray]) -> str:
    """The kind of an actor-critic's flat parameters: a value head ``Dense_2``
    beside an 8x8 ``Conv_0`` is the Atari agent's."""
    conv0 = flat.get("params/Conv_0/kernel")
    if "params/Dense_2/kernel" in flat and conv0 is not None and conv0.shape[:2] == (8, 8):
        return "atari_actor_critic"
    return "actor_critic"


def load_actor_critic(
    path: str, device="cuda", dtype: torch.dtype = torch.bfloat16
) -> Union[ActorCriticCNN, AtariActorCritic]:
    """An actor-critic with the exported weights, in eval mode on ``device``.

    The kind (:func:`flat_actor_critic_kind`), the actions, the input
    channels (the frame stack) and the board trunk's widths are read from
    the weights.
    """
    device = resolve_device(device)
    flat = load_flat(path)
    kind = flat_actor_critic_kind(flat)
    sd = from_flax_params(flat, kind)
    if kind == "atari_actor_critic":
        net = AtariActorCritic(n_actions=sd["policy.weight"].shape[0],
                               in_channels=sd["convs.0.weight"].shape[1], dtype=dtype)
    else:
        n = sum(1 for k in sd if k.startswith("encoder.convs.") and k.endswith(".weight"))
        net = ActorCriticCNN(
            n_actions=sd["policy.weight"].shape[0],
            features=[sd[f"encoder.convs.{i}.weight"].shape[0] for i in range(n)],
            in_channels=sd["encoder.convs.0.weight"].shape[1],
            dtype=dtype,
        )
    net.load_state_dict(sd)
    return net.to(device).eval()


def save_actor_critic(path: str, net: Union[ActorCriticCNN, AtariActorCritic]) -> None:
    """Write ``net``'s parameters as the flat float32 ``.npz`` that :func:`load_flat` reads."""
    np.savez(path, **to_flax_params(net.state_dict(), actor_critic_kind(net)))


def load_q_net(path: str, kind: str, device="cuda", dtype: torch.dtype = torch.bfloat16,
               board_shape=(20, 10)):
    """A Q-net with the exported weights, in eval mode on ``device``.

    ``kind`` is ``"qmlp"`` (widths read from the weights), ``"grouped_cnn"``
    (for boards of ``board_shape``, with a ``dtype`` trunk), ``"q_cnn"``
    (the same, with the frame stack and the actions read from the weights)
    or ``"atari_q"`` (84x84 frames; frame stack and actions from the weights).
    """
    device = resolve_device(device)
    sd = from_flax_params(load_flat(path), kind)
    if kind == "qmlp":
        n_hidden = sum(1 for k in sd if k.startswith("hidden.") and k.endswith(".weight"))
        net = QMLP(n_features=sd["hidden.0.weight"].shape[1],
                   hidden=[sd[f"hidden.{i}.weight"].shape[0] for i in range(n_hidden)])
    elif kind == "grouped_cnn":
        net = QGroupedBoardsCNN(board_shape=tuple(board_shape), dtype=dtype)
    elif kind == "q_cnn":
        net = QNetworkCNN(n_actions=sd["head.weight"].shape[0],
                          in_channels=sd["encoder.convs.0.weight"].shape[1],
                          board_shape=tuple(board_shape), dtype=dtype)
    elif kind == "atari_q":
        net = AtariQNetwork(n_actions=sd["head.weight"].shape[0],
                            in_channels=sd["convs.0.weight"].shape[1], dtype=dtype)
    else:
        raise ValueError(f"unknown Q-net kind {kind!r}")
    net.load_state_dict(sd)
    return net.to(device).eval()


def save_q_net(path: str, net, kind: str) -> None:
    """Write a Q-net's parameters as the flat float32 ``.npz`` that :func:`load_flat` reads."""
    np.savez(path, **to_flax_params(net.state_dict(), kind))
