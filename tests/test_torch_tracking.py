"""Experiment tracking and episode video capture of the port, against JAX's.

Mirrors ``tests/test_tracking.py`` case for case (the tracker off and
without wandb, both ``record_training_video`` cases, the greedy window), and
holds ``utils/video.py`` to ``tetris_gymnasium_tpu/utils/video.py``:

* the random policy's frames are bit-equal to JAX's at three seeds, on the
  default board and at 6x8 (the reset key, ``split`` and the shape-``()``
  ``randint`` are JAX's);
* the greedy frames of a ``QNetworkCNN`` carried over from JAX's
  initialisation through ``models/convert.py`` (float32 on both sides, so
  the argmax sees the same values) are bit-equal, with K = 1 and K = 4;
* the port's own GIF writer gives back its input frames exactly when read
  with imageio, and takes over when imageio is missing.
"""
import sys

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import QNetworkCNN as FlaxQNetworkCNN
from tetris_gymnasium_tpu.utils import video as jvideo

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.models.convert import from_flax_params
from tetris_gymnasium_torch.models.networks import QNetworkCNN
from tetris_gymnasium_torch.utils import video
from tetris_gymnasium_torch.utils.tracking import Tracker

CFG = EngineConfig(width=6, height=8)
JCFG = JEngineConfig(width=6, height=8)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tracker_disabled_is_noop():
    t = Tracker(enabled=False)
    assert not t.active
    t.log({"a": 1.0}, step=0)
    t.log_video("nonexistent.gif", step=0)
    t.finish()


def test_tracker_degrades_without_wandb(monkeypatch, capsys):
    """--wandb on a machine without the package: one warning, then no-op."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # forces ImportError
    t = Tracker(enabled=True)
    assert not t.active
    assert capsys.readouterr().err.count("wandb requested") == 1
    t.log({"a": 1.0}, step=0)  # must not raise
    t.log_video("nonexistent.gif", step=0)
    t.finish()


def _qnets(K):
    """A float32 Flax ``QNetworkCNN`` with its initial weights, and the port's
    net carrying them."""
    jnet = FlaxQNetworkCNN(dtype=jnp.float32)
    shape = (1, 8, 6) if K == 1 else (1, K, 8, 6)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros(shape, jnp.int8))
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    net = QNetworkCNN(in_channels=K, board_shape=(8, 6), dtype=torch.float32)
    net.load_state_dict(from_flax_params(flat, "q_cnn"))
    return jnet, params, net.eval()


@pytest.mark.parametrize("K, seed", [(1, 1), (4, 2)], ids=["qnet", "frame_stack"])
def test_record_training_video_qnet(K, seed, tmp_path):
    """``record_training_video`` of a Q-net writes a GIF of the greedy
    episode; its frames are JAX's for the same weights (K = 4: the capture
    feeds the net the same [1, K, H, W] window it trained on)."""
    jnet, params, net = _qnets(K)
    path = video.record_training_video(net, str(tmp_path / f"ep{K}.gif"), CFG, frame_stack=K,
                                       seed=seed, max_steps=60)
    assert path.endswith(".gif")
    frames = imageio.mimread(path)
    assert len(frames) > 1 and frames[0].shape[-1] in (3, 4)
    got = video.record_episode(video.greedy_policy_fn(net, K), CFG, seed=seed, max_steps=60,
                               device=CPU)
    want = jvideo.record_episode(jvideo.greedy_policy_fn(jnet, params, K), JCFG, seed=seed,
                                 max_steps=60)
    assert len(frames) == len(got)
    np.testing.assert_array_equal(got, want)


def test_greedy_policy_fn_window_semantics():
    """The host window mirrors ops.framestack: starts full of frame 0, then rolls."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(x[0].numpy().copy())
            return torch.zeros((1, 8))

    policy = video.greedy_policy_fn(Probe(), frame_stack=3)
    f = [torch.full((2, 2), i, dtype=torch.int8) for i in range(3)]
    for frame in f:
        assert policy(frame, None) == 0
    np.testing.assert_array_equal(seen[0], np.stack([f[0].numpy()] * 3))
    np.testing.assert_array_equal(seen[1], np.stack([f[0].numpy(), f[0].numpy(), f[1].numpy()]))
    np.testing.assert_array_equal(seen[2], np.stack([x.numpy() for x in f]))


@pytest.mark.parametrize("geo", [dict(), dict(width=6, height=8)], ids=["10x20", "6x8"])
@pytest.mark.parametrize("seed", [0, 2, 7])
def test_record_episode_random_matches_jax(geo, seed):
    """The random policy plays JAX's game: every frame bit-equal."""
    got = video.record_episode(config=EngineConfig(**geo), seed=seed, max_steps=200,
                               upscale_factor=2, device=CPU)
    want = jvideo.record_episode(config=JEngineConfig(**geo), seed=seed, max_steps=200,
                                 upscale_factor=2)
    assert got.dtype == np.uint8 and got.shape[-1] == 3 and len(got) >= 2
    np.testing.assert_array_equal(got, want)


def test_write_gif_reads_back_exactly(tmp_path):
    """The port's GIF writer, read back with imageio: the input frames, also
    over a full 256-colour palette and unchanged frames."""
    frames = video.record_episode(config=CFG, seed=3, max_steps=40, upscale_factor=3, device=CPU)
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (256, 3), dtype=np.uint8)[rng.integers(0, 256, (3, 19, 23))]
    noise[2] = noise[1]
    for name, f in (("episode", frames), ("noise", noise)):
        path = str(tmp_path / f"{name}.gif")
        video.write_gif(f, path, fps=8)
        back = imageio.mimread(path)
        assert len(back) == len(f), name
        for i, (b, x) in enumerate(zip(back, f)):
            np.testing.assert_array_equal(np.asarray(b)[..., :3], x, err_msg=f"{name} {i}")


def test_write_video_without_imageio(monkeypatch, tmp_path):
    """Without imageio ``write_video`` writes with the port's writer, and an
    ``.mp4`` request becomes the ``.gif`` beside it."""
    frames = video.record_episode(config=CFG, seed=4, max_steps=20, upscale_factor=2, device=CPU)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "imageio", None)  # forces ImportError
        path = video.write_video(frames, str(tmp_path / "ep.mp4"))
    assert path == str(tmp_path / "ep.gif")
    back = imageio.mimread(path)
    np.testing.assert_array_equal(np.stack([np.asarray(b)[..., :3] for b in back]), frames)
