"""The port's examples against the JAX package's, on the CPU.

* ``examples/evaluate_checkpoint.py`` prints what ``rl/evaluate.py:main``
  gives for the same arguments, rounded as the JAX example rounds (every
  statistic a float to 4 places), and at another geometry the JAX
  evaluation's statistics for the same Q-net weights (float32 on both
  sides; episode counts equal, means within 1e-6 relative, as
  ``tests/test_torch_dqn.py`` holds the evaluation);
* ``examples/record_video.py`` writes the frames JAX's would, random and
  greedy (the committed PPO policy in float32 on both sides);
* ``examples/play_random.py`` and ``examples/play_interactive.py`` (with a
  stub ``cv2`` whose ``waitKey`` returns a scripted key sequence) end in the
  state and ANSI render of the JAX shell driven by the same actions and keys;
* every argparse flag of each JAX trainer and example exists in its port,
  and parses there at JAX's default without raising.
"""
import ast
import json
import os
import runpy
import sys
import types

import gymnasium as gym
import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tetris_gymnasium_tpu.envs  # noqa: F401  (registers the JAX shell)
from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import ActorCriticCNN as FlaxActorCritic
from tetris_gymnasium_tpu.models.networks import QNetworkCNN as FlaxQNetworkCNN
from tetris_gymnasium_tpu.rl import evaluate as jevaluate
from tetris_gymnasium_tpu.utils import video as jvideo

from tetris_gymnasium_torch.examples import (
    evaluate_checkpoint, play_interactive, play_random, record_video, train_cnn,
    train_lin_grouped, train_ppo,
)
from tetris_gymnasium_torch.models.convert import from_flax_params
from tetris_gymnasium_torch.models.networks import QNetworkCNN
from tetris_gymnasium_torch.rl import evaluate
from tetris_gymnasium_torch.utils.checkpoint import load_flat, save_q_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "results", "ppo_lines_params.npz")
CPU = ["--device", "cpu", "--dtype", "float32"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nested(flat):
    """Flat ``{a/b/c: array}`` parameters as Flax's nested dict."""
    out = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(v)
    return out


# ---------------------------------------------------------------------------
# evaluate_checkpoint
# ---------------------------------------------------------------------------


def test_evaluate_checkpoint_equals_rl_evaluate(capsys):
    argv = ["--checkpoint", PARAMS, "--episodes", "4", "--max-steps", "80", "--seed", "3"] + CPU
    got = evaluate_checkpoint.main(["--net", "actor-critic"] + argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = evaluate.main(argv)
    assert printed == got == {k: round(float(v), 4) for k, v in want.items()}
    assert all(isinstance(v, float) for v in printed.values())
    assert got["episodes_completed"] + got["truncated"] == 4.0


def test_evaluate_checkpoint_other_geometry_matches_jax(tmp_path, capsys):
    """A Q-net at 6x8 (``--width 6 --height 8``): the port's example, the
    port's evaluation CLI and JAX's ``evaluate_q_checkpoint`` agree."""
    jnet = FlaxQNetworkCNN(dtype=jnp.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 6), jnp.int8))
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    net = QNetworkCNN(board_shape=(8, 6), dtype=torch.float32)
    net.load_state_dict(from_flax_params(flat, "q_cnn"))
    path = str(tmp_path / "q.npz")
    save_q_net(path, net, "q_cnn")
    geo = ["--width", "6", "--height", "8", "--episodes", "6", "--max-steps", "60", "--seed", "2"]
    got = evaluate_checkpoint.main(["--checkpoint", path] + geo + CPU)
    again = evaluate.main(["--net", "q", "--checkpoint", path] + geo + CPU)
    assert got == {k: round(float(v), 4) for k, v in again.items()}
    want = jevaluate.evaluate_q_checkpoint(jnet, params, 6, JEngineConfig(width=6, height=8),
                                           seed=2, max_steps=60)
    for k, v in want.items():
        np.testing.assert_allclose(again[k], v, rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# record_video
# ---------------------------------------------------------------------------


def test_record_video_random_writes_jax_frames(tmp_path):
    out = str(tmp_path / "ep.gif")
    frames, path = record_video.main(["--out", out, "--seed", "3", "--max-steps", "40",
                                      "--upscale", "2", "--device", "cpu"])
    want = jvideo.record_episode(config=JEngineConfig(), seed=3, max_steps=40, upscale_factor=2)
    np.testing.assert_array_equal(frames, want)
    assert path == out and len(imageio.mimread(path)) == len(frames)


def test_record_video_greedy_writes_jax_frames(tmp_path):
    """``--checkpoint`` with the committed PPO policy plays JAX's greedy episode."""
    frames, _ = record_video.main(["--out", str(tmp_path / "ep.gif"), "--seed", "1",
                                   "--max-steps", "60", "--upscale", "1", "--checkpoint", PARAMS,
                                   "--net", "actor-critic"] + CPU)
    jnet = FlaxActorCritic(dtype=jnp.float32)
    policy = jvideo.greedy_policy_fn(jnet, _nested(load_flat(PARAMS)))
    want = jvideo.record_episode(policy, JEngineConfig(), seed=1, max_steps=60, upscale_factor=1)
    np.testing.assert_array_equal(frames, want)


# ---------------------------------------------------------------------------
# play_random, play_interactive
# ---------------------------------------------------------------------------


def _jax_shell_after(actions, mode="ansi"):
    env = gym.make("tetris_gymnasium_tpu/Tetris", render_mode=mode)
    env.reset(seed=42)
    for a in actions:
        env.step(a)
    return env.unwrapped


def _same_game(port_env, jax_env):
    np.testing.assert_array_equal(port_env.state.board[0].numpy(), np.asarray(jax_env.state.board))
    assert float(port_env.state.score[0]) == float(jax_env.state.score)
    assert port_env._render_ansi() == jax_env._render_ansi()


def test_play_random_matches_the_jax_shell(capsys):
    env, actions = play_random.play(device="cpu", every=20)
    out = capsys.readouterr().out
    assert f"Game Over! ({len(actions)} steps)" in out and out.count("\n\n") >= len(actions) // 20
    assert bool(env.state.game_over[0])
    jax_env = _jax_shell_after(actions)
    assert bool(jax_env.state.game_over)
    _same_game(env, jax_env)
    assert env.render() == jax_env.render()


KEYS = [ord(c) for c in "adzz s eqc r a sdd ee  qqc  a d"] + [ord("x")]


@pytest.fixture()
def stub_cv2(monkeypatch):
    """A ``cv2`` whose ``waitKey(0)`` returns ``KEYS`` in turn (``waitKey(1)``,
    the shell's refresh, returns -1) and whose window calls do nothing."""

    def install():
        keys = iter(KEYS)
        cv2 = types.SimpleNamespace(
            COLOR_RGB2BGR=4, shown=[],
            cvtColor=lambda img, code: img[..., ::-1],
            waitKey=lambda delay=0: next(keys) if delay == 0 else -1,
            destroyAllWindows=lambda: None,
        )
        cv2.imshow = lambda name, img: cv2.shown.append(img.shape)
        monkeypatch.setitem(sys.modules, "cv2", cv2)
        return cv2

    return install


def test_play_interactive_matches_the_jax_example(stub_cv2, capsys):
    """The same scripted keys through the port's example and JAX's
    (``examples/play_interactive.py`` run as a script): moves, an unmapped
    key, a restart, then quit; the same final game."""
    cv2 = stub_cv2()
    env = play_interactive.play(device="cpu")
    assert "Game Over!" in capsys.readouterr().out and cv2.shown
    assert cv2.shown[0] == (240, 340, 3)  # the shell's 10x upscale of the 24x34 frame
    stub_cv2()
    jax_globals = runpy.run_path(os.path.join(REPO, "examples", "play_interactive.py"),
                                 run_name="__main__")
    jax_env = jax_globals["env"].unwrapped
    assert int(jax_env.state.steps) == int(env.state.steps[0]) > 0
    _same_game(env, jax_env)


# ---------------------------------------------------------------------------
# Flags: every JAX flag exists in the port and parses
# ---------------------------------------------------------------------------


def _jax_flags(name):
    """``{flag: (is_store_true, default, choices)}`` of a JAX example's parser."""
    tree = ast.parse(open(os.path.join(REPO, "examples", f"{name}.py")).read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flag = node.args[0].value
            store_true = isinstance(kw.get("action"), ast.Constant) and kw["action"].value == "store_true"
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            choices = ast.literal_eval(kw["choices"]) if "choices" in kw else None
            flags[flag] = (store_true, default, choices)
    return flags


PORTS = {"train_ppo": train_ppo, "train_cnn": train_cnn, "train_lin_grouped": train_lin_grouped,
         "evaluate_checkpoint": evaluate_checkpoint, "record_video": record_video}


@pytest.mark.parametrize("name", sorted(PORTS))
def test_every_jax_flag_parses_in_the_port(name):
    flags = _jax_flags(name)
    assert flags, name
    base = ["--checkpoint", "x.npz"] if name == "evaluate_checkpoint" else []
    for flag, (store_true, default, choices) in flags.items():
        if store_true:
            argv = [flag]
        else:
            value = default if default is not None else (choices[0] if choices else "x")
            argv = [flag, str(value)]
        args = PORTS[name].parse_args((base if flag != "--checkpoint" else []) + argv)
        dest = flag[2:].replace("-", "_")
        assert getattr(args, dest) == (True if store_true else type(getattr(args, dest))(argv[1])), flag


def test_every_jax_example_has_a_port():
    ours = set(os.listdir(os.path.join(REPO, "tetris_gymnasium_torch", "examples")))
    theirs = {f for f in os.listdir(os.path.join(REPO, "examples")) if f.endswith(".py")}
    assert theirs <= ours, theirs - ours
