#!/usr/bin/env python3
"""Device ms of ``fn_step`` (with ``fn_reset`` and ``fn_observe``),
``replay_sample_stacked``, ``replay_add`` and ``replay_sample`` at the
shapes the earlier slices time them, for the port found under ``--repo``:

    python tools/time_fn_replay_kernels.py [--repo DIR] [--label NAME] [--ptxas] [--ablate]
        [--kernels fn,stacked,add,sample,act,reset]

``fn_step`` at 10x20 on live states (8 steps into a fresh rollout, as
``chip_smoke.py`` phase 43) and on frozen ones, ``fn_reset`` and
``fn_observe``, at B = 1, 8192 and 65536, and ``fn_step`` at 30x20 and 8x12
with padding 2 at 8192 and 65536; ``replay_sample_stacked`` (K = 4) on a
full 262,144-entry buffer of 84x84 pixel frames (512 envs a block, the
pixel DQN's, phase 25) and of 20x10 board frames (1024 envs a block, the
board DQN's, phase 20), at n = 512 and 65536.  Each as the wrapper takes
it, and each build of ``kernels.FN_STEP_BUILDS`` and
``kernels.REPLAY_STACKED_BUILDS`` that fits where the tree has them.  As a
yardstick for the replay's gather alone, ``torch.index_select`` of the
same 2nK frame rows given their indices (no single call draws the entries
and walks the windows, so it is no library time of the kernel).
``replay_add`` at each DQN path's shape: the pixel DQN's 512 envs (the
newest 7056-byte frame of a ``[B, 4, 84, 84]`` window, a strided view, with
action, reward and done) and 65536 such envs, the grouped DQN's 1024 envs
(``[40, 13]`` float32 features, the engine's ``[A, B]`` mask transposed,
action, reward, done) and the board DQN's 1024 envs (the newest 200-byte
int8 frame of a ``[B, 4, 20, 10]`` window), into the paths' buffers
(262,144 entries, 131,072 for the grouped DQN), beside the library's copy
of the obs field alone, ``store.narrow(0, pos, B).copy_(obs)``.
``replay_sample`` at ``SAMPLE_CASES``: the grouped DQN's 256 samples with
their successors from its full 131,072-entry buffer of 2249-byte entries
(1024 envs a block; ``chip_smoke.py`` phase 16), the CNN DQN's 512 of its
262,144 entries of 209 bytes at K = 1 (phase 20), 65536 of each, and the
grouped buffer's 256 without successors (``buffers.sample``), each beside
its byte bound (every entry and successor read once and written once);
as a yardstick, one ``torch.index_select`` of the obs field's rows given
their indices.  ``act``: ``dqn_act`` at A = 8 with keys at ``ACT_B`` (the
DQN paths' 512 and 1024, ``--train dqn``'s 32768 a rank at W = 2, and
65536), its greedy launch at ``ACT_GREEDY_B`` beside ``torch.argmax(q,
-1)``, its ``call_ms`` with keys at 512 and 1024 (the host time of a
Python call: CUDA events around 200 calls on an idle card), A = 5 and 40
at 1024, each beside its byte bound (4 A read and 4 written an env), and
the DQN steps' ``act`` part (the split of the step's key, the Q forward
and ``dqn.act``, between ``make_train_step``'s marks, before learning) of
the board DQN (K = 4, 1024 envs) and the pixel DQN (512 envs).
``reset``: ``fn_reset`` at ``RESET_CASES`` (10x20 at B = 1, 8192 and
65536; 30x20 and 8x12 with padding 2 at 8192 and 65536; the uniform queue
of 5 at 8192) beside its byte bound (the key read; the returned key, the
state and the observation written).  Each
the median over 7 replays of a CUDA graph of 100 launches (10 at 65536, 5
for the pixel replay at 65536).  ``--kernels`` times only the kernels it
names (fn, stacked, add and sample by default).  What the other tree lacks
is skipped; the launch floor (``torch.cuda._sleep(0)``) is timed in every
run.

With ``--ptxas`` it first builds ``fn_env.cu`` at 10x20, 30x20 and 8x12
with padding 2 (where ``--kernels`` names fn) and ``replay.cu``, and
prints each kernel's registers, spills and shared memory, and each
``fn_step`` build's blocks an SM
(``kernels.fn_step_occupancy``).  With ``--ablate`` it times, in place of
all that, ``fn_step`` at 10x20 (B = 1, 8192, 65536), the pixel replay (n =
512, 65536), ``replay_add`` at its four shapes, ``replay_sample`` at
``SAMPLE_CASES``, ``dqn_act`` at 512, 1024 and 65536 (keys and greedy; A = 5 and 40 at
1024) and ``fn_reset`` at ``RESET_ABLATE_CASES`` beside patched copies of
their sources that each skip one part (``ABLATIONS``, by kernel; the tool
stops where the tree at ``--repo`` does not hold a patch's text; built under
``DIR/build/ablate/``): their games and frames are wrong by design, only
their times mean anything.  Prints one JSON line
with the card's name and power limit.  To compare two trees on one card,
unpack the other into a directory that ``.gitignore`` lists and run both in
one call, in turns: A, B, B, A.  Needs a card; builds the kernels of
``DIR`` into its own ``build/``.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FN_B = (1, 8192, 65536)
FN_WIDE_B = (8192, 65536)
REPLAY_N = (512, 65536)
REPLAY_CAPACITY = 262_144
K = 4
LIVE_STEPS = 8
GROUPED_CAPACITY = 131_072
ADD_CASES = (("pixel", 512), ("grouped", 1024), ("board", 1024), ("pixel", 65536))
# replay_sample: (buffer, samples, with successors)
SAMPLE_CASES = (("grouped", 256, True), ("board", 512, True), ("grouped", 65536, True),
                ("board", 65536, True), ("grouped", 256, False))
ACT_B = (512, 1024, 32768, 65536)
ACT_GREEDY_B = (512, 1024, 65536)
ACT_CALL_B = (512, 1024)
ACT_OTHER_A = (5, 40)  # at 1024
ACT_ABLATE_B = (512, 1024, 65536)
RESET_CASES = (("10x20", 1), ("10x20", 8192), ("10x20", 65536), ("30x20", 8192), ("30x20", 65536),
               ("8x12-pad2", 8192), ("8x12-pad2", 65536), ("uniform5", 8192))
RESET_ABLATE_CASES = (("10x20", 1), ("10x20", 8192), ("10x20", 65536), ("30x20", 8192), ("30x20", 65536),
                      ("8x12-pad2", 65536))

# --ablate's patched copies: (kernel, source, variant, [(text, replacement), ...]);
# the tree's source must hold each text once.
_NO_LOGIC = ("    if (!over_in) {\n      uint64_t m = ", "    if (false) {\n      uint64_t m = ")
# replay_sample, units of a sample's words: the draw, the loads (the stores
# write what the address was), the stores or everything (the launch alone)
# left out; and other shapes (not ablations: their samples are right): a
# warp a unit at every n, narrow groups and 16 words a lane at every n, 4
# or 16 words a lane always, one warp a block
_GROUP_NO_DRAW = ("    const uint32_t off = fast_mod(fast_mod(hi, m, p.span) * p.multiplier + fast_mod(lo, m, p.span), m, p.span);",
                  "    const uint32_t off = static_cast<uint32_t>(s);")
_SLOTS = "  plan.slots = static_cast<long long>(p.n) * few * g <= room ? kSlotsFew : kSlotsMany;"
_LOADS = ("      if (f.word == 16) v[k] = __ldg(reinterpret_cast<const uint4*>(src));\n"
          "      else if (f.word == 4) v[k].x = __ldg(reinterpret_cast<const uint32_t*>(src));\n"
          "      else v[k].x = __ldg(reinterpret_cast<const uint8_t*>(src));\n")
_STORES = ("    if (size[k] == 16) *reinterpret_cast<uint4*>(dst[k]) = v[k];\n"
           "    else if (size[k] == 4) *reinterpret_cast<uint32_t*>(dst[k]) = v[k].x;\n"
           "    else if (size[k] == 1) *dst[k] = static_cast<char>(v[k].x);\n")
_SAMPLE_GROUP_ABLATIONS = [
    ("sample", "replay", "group_no_draw", [_GROUP_NO_DRAW]),
    ("sample", "replay", "group_warp_always", [("  int g = 8;\n", "  int g = 32;\n")]),
    ("sample", "replay", "group_narrow", [("constexpr int kWarpsPerSM = 16;", "constexpr int kWarpsPerSM = 0;")]),
    ("sample", "replay", "group_slots_few", [(_SLOTS, "  plan.slots = kSlotsFew;")]),
    ("sample", "replay", "group_slots_many", [(_SLOTS, "  plan.slots = kSlotsMany;")]),
    ("sample", "replay", "group_one_warp_a_block",
     [("constexpr int kMaxGroupThreads = 256;", "constexpr int kMaxGroupThreads = 32;")]),
    ("sample", "replay", "group_no_loads", [(_LOADS, "      v[k] = make_uint4(static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src)), 0u, 0u, 0u);\n")]),
    ("sample", "replay", "group_no_stores", [(_STORES, "    if (v[k].x == 0x9e3779b9u && v[k].y == 1u) *dst[k] = 0;\n")]),
    # the launch alone: every thread returns at once
    ("sample", "replay", "group_empty", [("  const int G = plan.group;\n  const int lane = threadIdx.x & (G - 1);\n",
                                          "  if (p.n > 0) return;\n  const int G = plan.group;\n  const int lane = threadIdx.x & (G - 1);\n")]),
]
ABLATIONS = [
    # fn_step: the fields, the boards' round trip, the bit rows and the observation stay
    ("fn", "fn_env", "no_logic", [_NO_LOGIC]),
    # fn_step: no observation
    ("fn", "fn_env", "no_obs", [("    group_obs_maps(g, maps", "    if (false) group_obs_maps(g, maps"),
                                ("  write_obs_maps(obs + ", "  if (false) write_obs_maps(obs + ")]),
    # fn_step: the boards neither come in nor go out (the game reads garbage)
    ("fn", "fn_env", "no_staging", [("      bulk::arrive_expect(&bar, span);\n      bulk::load(boards,",
                                     "      bulk::arrive_expect(&bar, 0);\n      if (false) bulk::load(boards,"),
                                    ("      bulk::store(board_out, boards, span);",
                                     "      if (false) bulk::store(board_out, boards, span);")]),
    # fn_step: at most 32 registers a thread, 16 blocks an SM
    ("fn", "fn_env", "bounds16", [("__launch_bounds__(kStepThreads) fn_step_kernel",
                                   "__launch_bounds__(kStepThreads, 16) fn_step_kernel")]),
    # replay: no done flag is read, every window is K deep
    ("stacked", "replay", "no_lookback", [("  const bool f = lane < st.k && st.done[back(a, lane, p)];",
                                           "  const bool f = false;")]),
    # replay: the frames are not staged, the stores write whatever shared memory holds
    ("stacked", "replay", "no_staging", [
        ("    bulk::arrive_expect(&bar, m.slots * row);\n    for (int i = 0; i < m.slots; ++i)",
         "    bulk::arrive_expect(&bar, 0);\n    for (int i = 0; i < 0; ++i)")]),
    # replay_add on the flat grid: at most 2048 and 131072 blocks a field of words
    ("add", "replay", "runs2048", [("constexpr int kAddMaxRuns = 32768;", "constexpr int kAddMaxRuns = 2048;")]),
    ("add", "replay", "runs131072", [("constexpr int kAddMaxRuns = 32768;", "constexpr int kAddMaxRuns = 131072;")]),
] + _SAMPLE_GROUP_ABLATIONS + [
    # dqn_act's A = 8 build: the row's loads (values from the env index),
    # the draws (the split, the randint bits and the uniform from the
    # counter), the split alone (the action key used as the low half),
    # everything (the launch alone)
    ("act", "dqn_act", "act_no_loads",
     [("    if (p.vec) {  // the row's two 16-byte words, both in flight", "    if (false) {"),
      ("      for (int a = 0; a < 8; ++a) v[a] = __ldg(qb + a);",
       "      for (int a = 0; a < 8; ++a) v[a] = static_cast<float>((b * 7 + a * 13) & 15);")]),
    ("act", "dqn_act", "act_no_draws",
     [("      const uint2 k_lo = tf::block(p.act_k0, p.act_k1, 0u, 1u);  // split(act_key)[1]\n"
       "      random_a = static_cast<int>(tf::bits(k_lo.x, k_lo.y, 0u, c) % kA);",
       "      random_a = static_cast<int>((c * 2654435761u) % kA);"),
      ("    const float u = tf::uniform(tf::bits(p.eps_k0, p.eps_k1, 0u, c), 0.0f, 1.0f);",
       "    const float u = tf::uniform(c * 40503u, 0.0f, 1.0f);")]),
    ("act", "dqn_act", "act_no_split",
     [("      const uint2 k_lo = tf::block(p.act_k0, p.act_k1, 0u, 1u);  // split(act_key)[1]",
       "      const uint2 k_lo = make_uint2(p.act_k0, p.act_k1);")]),
    ("act", "dqn_act", "act_empty",
     [("  const int b = blockIdx.x * blockDim.x + threadIdx.x;\n  if (b >= B) return;",
       "  const int b = blockIdx.x * blockDim.x + threadIdx.x;\n  if (B > 0) return;")]),
    # fn_reset: the board stream, the observation's zero words, the words
    # the pieces touch, the chain (the key's halves and queue from the key
    # as it is), the queue tile's store, the first design's insertion sort
    # in place of the ranks, everything (the launch alone)
    ("reset", "fn_env", "reset_no_board", [("  if (si < SB) {", "  if (false) {")]),
    ("reset", "fn_env", "reset_no_obs_stream",
     [("    if (!piece_word(16 * i)) reinterpret_cast<uint4*>(obs)[i]",
       "    if (false) reinterpret_cast<uint4*>(obs)[i]")]),
    ("reset", "fn_env", "reset_no_piece_words",
     [("    if (w > (e * OBS + kWinHi - 1) / 16 || w >= full) continue;",
       "    if (w > (e * OBS + kWinHi - 1) / 16 || w >= full || w >= 0) continue;")]),
    ("reset", "fn_env", "reset_no_chain",
     [("  const uint2 first = tf::block(key.x, key.y, 0u, 0u), second = tf::block(key.x, key.y, 0u, 1u);",
       "  const uint2 first = key, second = make_uint2(key.y, key.x);"),
      ("  ranked_queue(first, uniform, q);",
       "#pragma unroll\n  for (int j = 0; j < QS; ++j) q[j] = (first.x >> j) & 3;")]),
    ("reset", "fn_env", "reset_no_queue_tile",
     [("  store_ints(out.queue + b0 * QS, tile, m * QS, lane);",
       "  if (m < 0) store_ints(out.queue + b0 * QS, tile, m * QS, lane);")]),
    ("reset", "fn_env", "reset_insertion_sort",
     [("  ranked_queue(first, uniform, q);", "  fresh_queue(first.x, first.y, uniform, q);")]),
    # fn_reset at most 64 or 128 envs a block at every geometry (shapes, not ablations)
    ("reset", "fn_env", "reset_envs64", [("constexpr int kResetMaxEnvs = pow2_floor(131072 / (CELLS + OBS)) < 128 ? pow2_floor(131072 / (CELLS + OBS)) : 128;", "constexpr int kResetMaxEnvs = 64;")]),
    ("reset", "fn_env", "reset_envs128", [("constexpr int kResetMaxEnvs = pow2_floor(131072 / (CELLS + OBS)) < 128 ? pow2_floor(131072 / (CELLS + OBS)) : 128;", "constexpr int kResetMaxEnvs = 128;")]),
    # fn_reset: the env warps stream their share too, after their chains (a shape)
    ("reset", "fn_env", "reset_env_warps_stream",
     [("  else\n    stream_reset(out.board + base * CELLS, obs + base * OBS, n, t - first, kResetThreads - first);",
       "  stream_reset(out.board + base * CELLS, obs + base * OBS, n, t, kResetThreads + 0 * first);")]),
    ("reset", "fn_env", "reset_empty",
     [("  const int t = threadIdx.x, warp = t / 32, lane = t % 32;\n  const long long base",
       "  if (B > 0) return;\n  const int t = threadIdx.x, warp = t / 32, lane = t % 32;\n  const long long base")]),
]


def _ablations(repo, chosen):
    """The variants of ``ABLATIONS`` for the kernels in ``chosen``; stops
    where the tree at ``repo`` does not hold each patch's text once."""
    out, missing = [], []
    for kernel, source, variant, patches in ABLATIONS:
        if kernel not in chosen:
            continue
        with open(os.path.join(repo, "tetris_gymnasium_torch", "csrc", f"{source}.cu")) as f:
            text = f.read()
        if all(text.count(old) == 1 for old, _ in patches):
            out.append((kernel, source, variant, patches))
        else:
            missing.append(variant)
    if missing:
        raise SystemExit(f"time_fn_replay_kernels: ablations {missing} do not match the sources")
    return out


def _patched_libs(repo, kernels, jobs):
    """Build each ``(source, variant, patches, defines)`` of ``jobs`` from a
    patched copy of ``DIR``'s ``csrc/``; returns the libraries' paths."""
    csrc = os.path.join(repo, "tetris_gymnasium_torch", "csrc")

    def build(job):
        source, variant, patches, defines = job
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            text = f.read()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"time_fn_replay_kernels: {source}.cu does not hold {old!r} once")
            text = text.replace(old, new)
        tag = "_".join(str(v) for _, v in defines)
        d = os.path.join(repo, "build", "ablate", f"{source}_{variant}" + (f"_{tag}" if tag else ""))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        path, so = os.path.join(d, f"{source}.cu"), os.path.join(d, f"{source}.so")
        with open(path, "w") as f:
            f.write(text)
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *kernels._define_flags(defines),
                            "-o", so, path], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {source} {variant}:\n{r.stderr[-3000:]}")
        return so

    with ThreadPoolExecutor(max_workers=min(16, len(jobs))) as pool:  # more nvcc at once have crashed
        return list(pool.map(build, jobs))


def _load(kernels, so, source, defines):
    lib = ctypes.CDLL(so)
    for fn, argtypes in kernels._ENTRY_POINTS[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    kernels._LIBS[(source, defines)] = lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--kernels", default="fn,stacked,add,sample")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fn_replay_kernels: needs a CUDA card")
    chosen = set(args.kernels.split(","))
    if not chosen <= {"fn", "stacked", "add", "sample", "act", "reset"}:
        raise SystemExit("time_fn_replay_kernels: --kernels takes fn, stacked, add, sample, act and reset")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from chip_smoke import call_ms, device_ms
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EnvConfig
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.pieces import PIECES
    from tetris_gymnasium_torch.rl import buffers, dqn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(43)
    geos = {"10x20": EnvConfig(), "30x20": EnvConfig(width=30),
            "8x12-pad2": EnvConfig(width=8, height=12, padding=2)}
    reset_geos = {**geos, "uniform5": EnvConfig(queue_size=5)}
    fn_builds = getattr(kernels, "FN_STEP_BUILDS", ())
    replay_builds = getattr(kernels, "REPLAY_STACKED_BUILDS", ())
    builds = {}
    if args.ptxas:
        fn_geos = geos if chosen & {"fn", "reset"} else {}
        jobs = [("fn_env", kernels.fn_defines(c, PIECES)) for c in fn_geos.values()]
        jobs.append(("replay", ()))
        names = [*fn_geos, "replay"]
        if "act" in chosen:
            jobs.append(("dqn_act", ()))
            names.append("dqn_act")
        for job in jobs:  # ptxas speaks only when it compiles
            path = kernels._lib_path(kernels.SOURCES[job[0]], job[1])
            if path.exists():
                path.unlink()
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            facts = list(pool.map(lambda job: kernels._compile(*job), jobs))
        for name, f in zip(names, facts):
            builds[name] = {"ptxas": [l.strip() for l in f["ptxas"].splitlines()
                                      if "registers" in l or "spill" in l or "Compiling" in l
                                      or "smem" in l]}
            if name in geos and hasattr(kernels, "fn_step_occupancy"):
                builds[name]["occupancy"] = [kernels.fn_step_occupancy(geos[name], PIECES, b)
                                             for b in fn_builds]

    def live(cfg, B):
        s = kernels.fn_reset(batch_keys(prng_key(43), B, device=dev), cfg, PIECES)[1]
        for _ in range(LIVE_STEPS):
            s = kernels.fn_step(s, torch.randint(0, 7, (B,), generator=g, device=dev,
                                                 dtype=torch.int32), cfg, PIECES)[0]
        return s, torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32)

    def fn_times(cfg, s, a, tag, n, frozen=True):
        out = {f"fn_step{tag}": device_ms(lambda: kernels.fn_step(s, a, cfg, PIECES), n)}
        for b in fn_builds:
            if b == "bulk" and kernels.fn_step_build(cfg, s.board, s.board) != "bulk":
                continue
            out[f"fn_step_{b}{tag}"] = device_ms(lambda: kernels.fn_step(s, a, cfg, PIECES, build=b), n)
        if frozen:
            f = s.replace(game_over=torch.ones_like(s.game_over))
            out[f"fn_step_frozen{tag}"] = device_ms(lambda: kernels.fn_step(f, a, cfg, PIECES), n)
        return out

    def replay_buffer(frame, dtype, B):
        cap = REPLAY_CAPACITY
        if dtype == torch.uint8:
            obs = torch.randint(0, 256, (cap, *frame), generator=g, device=dev, dtype=dtype)
        else:
            obs = torch.randint(-1, 2, (cap, *frame), generator=g, device=dev, dtype=dtype)
        data = {"obs": obs, "action": torch.randint(0, 8, (cap,), generator=g, device=dev, dtype=torch.int32),
                "reward": torch.randn((cap,), generator=g, device=dev),
                "done": torch.rand((cap,), generator=g, device=dev) < 0.15}
        return buffers.ReplayBuffer(data, pos=(cap // 3) // B * B, size=cap)

    def replay_times(buf, B, n, tag, reps, yardstick=True):
        key = prng_key(3)
        out = {f"replay_sample_stacked{tag}": device_ms(
            lambda: buffers.sample_with_next_stacked(buf, key, n, B, K), reps)}
        start, n_valid = buffers._stacked_window(buf, B, K)
        for b in replay_builds:
            row = buf.data["obs"][0].numel()
            if b == "bulk" and kernels.replay_stacked_build(row, K, buf.data["obs"]) != "bulk":
                continue
            out[f"replay_sample_stacked_{b}{tag}"] = device_ms(
                lambda: kernels.replay_sample_stacked(buf.data, key, n, n_valid, start, B, K, build=b), reps)
        if yardstick:
            _, windows, _ = buffers.stacked_sample_rows(buf, key, n, B, K)
            rows = windows.flatten()
            out[f"index_select{tag}"] = device_ms(lambda: torch.index_select(buf.data["obs"], 0, rows), reps)
        return out

    def add_case(kind, B):
        """The buffer and one transition batch of a DQN path's replay_add."""
        cap = REPLAY_CAPACITY if kind != "grouped" else GROUPED_CAPACITY
        common = {"action": torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32),
                  "reward": torch.randn((B,), generator=g, device=dev),
                  "done": torch.rand((B,), generator=g, device=dev) < 0.05}
        if kind == "grouped":
            A = 40
            blk = {"obs": torch.randn((B, A, 13), generator=g, device=dev),
                   "mask": (torch.rand((A, B), generator=g, device=dev) < 0.5).float().T, **common}
        else:
            frame, dtype = ((84, 84), torch.uint8) if kind == "pixel" else ((20, 10), torch.int8)
            window = torch.randint(-1 if kind == "board" else 0, 2 if kind == "board" else 256,
                                   (B, K, *frame), generator=g, device=dev, dtype=dtype)
            blk = {"obs": window[:, -1], **common}
        data = {k: torch.zeros((cap, *x.shape[1:]), dtype=x.dtype, device=dev) for k, x in blk.items()}
        return buffers.ReplayBuffer(data, pos=(cap // 2) // B * B, size=cap), blk

    def sample_case(kind):
        """A full, wrapped buffer of a DQN path whose replay_sample is timed."""
        buf, _ = add_case(kind, 1024)
        for x in buf.data.values():  # entries of random bytes, done flags ~5%
            if x.dtype == torch.bool:
                x.copy_(torch.rand(x.shape, generator=g, device=dev) < 0.05)
            elif x.dtype.is_floating_point:
                x.normal_(generator=g)
            else:
                x.random_(-100, 100, generator=g)
        return buf

    def sample_times(buf, n, with_next, tag, reps, yardstick=True):
        key = prng_key(5)
        B = 1024
        if with_next:
            start, n_valid = buffers._successor_window(buf, B)
            fn = lambda: kernels.replay_sample(buf.data, key, n, n_valid, start=start, batch=B)  # noqa: E731
        else:
            start, n_valid = 0, buf.size
            fn = lambda: kernels.replay_sample(buf.data, key, n, n_valid)  # noqa: E731
        out = {f"replay_sample{tag}": device_ms(fn, reps)}
        if yardstick:
            entry = sum(x[0].numel() * x.element_size() for x in buf.data.values())
            halves = 2 if with_next else 1
            out[f"bound{tag}"] = 1e3 * 2 * halves * n * entry / 3.35e12
            off = torch.as_tensor(threefry.randint(key, n, n_valid).astype("int64"), device=dev)
            rows = (start + off) % buf.capacity
            if with_next:
                rows = torch.cat([rows, (rows + B) % buf.capacity])
            out[f"index_select{tag}"] = device_ms(lambda: torch.index_select(buf.data["obs"], 0, rows), reps)
        return out

    def add_times(buf, blk, tag, reps, yardstick=True):
        out = {f"replay_add{tag}": device_ms(lambda: kernels.replay_add(buf.data, blk, buf.pos), reps)}
        if yardstick:
            dst = buf.data["obs"].narrow(0, buf.pos, blk["obs"].shape[0])
            out[f"obs_copy{tag}"] = device_ms(lambda: dst.copy_(blk["obs"]), reps)
        return out

    def act_case(B, A=8):
        q = torch.randn((B, A), generator=g, device=dev)
        act_key, eps_key = threefry.split(threefry.prng_key(B + A))
        return q, act_key, eps_key

    def act_times(B, A, tag, reps, greedy=True, host=False, yardstick=True):
        q, act_key, eps_key = act_case(B, A)
        out = {f"dqn_act{tag}": device_ms(lambda: kernels.dqn_act(q, act_key, eps_key, 0.3), reps)}
        if greedy:
            out[f"dqn_act_greedy{tag}"] = device_ms(lambda: kernels.dqn_act(q), reps)
        if host:  # a Python call's host time, the wrapper's work included
            out[f"dqn_act_call{tag}"] = call_ms(lambda: kernels.dqn_act(q, act_key, eps_key, 0.3), 200)
        if yardstick:
            out[f"dqn_act_bound{tag}"] = 1e3 * B * (4 * A + 4) / 3.35e12
            if greedy:
                out[f"argmax{tag}"] = device_ms(lambda: torch.argmax(q, -1), reps)
        return out

    def act_part(obs_kind, B):
        """Mean ms of the DQN step's act part (before learning) on this tree."""
        from tetris_gymnasium_torch.config import EngineConfig

        cfg = dqn.DQNConfig(buffer_size=16 * B, learning_starts=10**9, exploration_steps=1000,
                            frame_stack=4)
        impl = "flagship" if obs_kind == "rgb84" else "turbo"
        env_config = EngineConfig(auto_reset=True)
        ts = dqn.init_dqn_state(prng_key(7), B, env_config, cfg, impl=impl, obs=obs_kind, device=dev)
        events = []

        def mark(name):
            if name in ("start", "act"):
                if name == "start":
                    events.append({})
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events[-1][name] = ev

        step = dqn.make_train_step(env_config, cfg, impl=impl, obs=obs_kind, marks=mark)
        for _ in range(60):
            ts, _ = step(ts)
        torch.cuda.synchronize()
        ms = [e["start"].elapsed_time(e["act"]) for e in events[10:]]
        del ts
        torch.cuda.empty_cache()
        return sum(ms) / len(ms)

    def reset_bytes(cfg, B):
        state = 8 + cfg.padded_height * cfg.padded_width + 4 * 5 + 4 * cfg.queue_size + 1 + 4
        return B * (8 + 8 + state + cfg.height * cfg.width)

    def reset_times(name, B, tag, reps, yardstick=True):
        cfg = reset_geos[name]
        kind = "uniform" if name == "uniform5" else "bag"
        keys = batch_keys(prng_key(43), B, device=dev)
        out = {f"fn_reset{tag}": device_ms(lambda: kernels.fn_reset(keys, cfg, PIECES, kind), reps)}
        if yardstick and hasattr(kernels, "fn_reset_shape"):
            out[f"fn_reset_shape{tag}"] = kernels.fn_reset_shape(cfg, PIECES, B)
        if yardstick:
            out[f"fn_reset_bound{tag}"] = 1e3 * reset_bytes(cfg, B) / 3.35e12
        return out

    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    if args.ablate:
        cfg = geos["10x20"]
        fn_def = kernels.fn_defines(cfg, PIECES)
        pix = replay_buffer((84, 84), torch.uint8, 512) if "stacked" in chosen else None
        cases = {B: live(cfg, B) for B in FN_B} if "fn" in chosen else {}
        adds = {(kind, B): add_case(kind, B) for kind, B in ADD_CASES} if "add" in chosen else {}
        samples = {kind: sample_case(kind) for kind in ("grouped", "board")} if "sample" in chosen else {}

        def time_all(variant, kernel):
            res = {}
            if kernel == "fn":
                for B, (s, a) in cases.items():
                    res[f"fn_step_{variant}@{B}"] = device_ms(
                        lambda: kernels.fn_step(s, a, cfg, PIECES), 10 if B >= 65536 else 100)
            elif kernel == "sample":
                for kind, n, with_next in SAMPLE_CASES:
                    res.update({f"replay_sample_{variant}@{kind}@{n}{'' if with_next else '@nonext'}": v
                                for v in sample_times(samples[kind], n, with_next, "", 10 if n >= 65536 else 100,
                                                      yardstick=False).values()})
            elif kernel == "act":
                for B in ACT_ABLATE_B:
                    res.update({f"{k}_{variant}": v for k, v in act_times(
                        B, 8, f"@{B}", 100, yardstick=False).items()})
                for A in ACT_OTHER_A:
                    res.update({f"{k}_{variant}": v for k, v in act_times(
                        1024, A, f"@A{A}@1024", 100, yardstick=False).items()})
            elif kernel == "reset":
                for name, B in RESET_ABLATE_CASES:
                    res.update({f"{k}_{variant}": v for k, v in reset_times(
                        name, B, f"@{name}@{B}", 100, yardstick=False).items()})
            elif kernel == "stacked":
                for n in REPLAY_N:
                    res.update({f"{k}_{variant}": v for k, v in replay_times(
                        pix, 512, n, f"@{n}", 5 if n >= 65536 else 100, yardstick=False).items()
                        if k == f"replay_sample_stacked@{n}"})
            else:
                for (kind, B), (buf, blk) in adds.items():
                    res.update({f"replay_add_{variant}@{kind}@{B}": v for v in add_times(
                        buf, blk, "", 10 if B >= 65536 else 100, yardstick=False).values()})
            return res

        for kernel in ("fn", "stacked", "add", "sample", "act", "reset"):
            if kernel in chosen:
                out.update(time_all("full", kernel))
        # a variant's builds: fn_env at 10x20, and for reset at each geometry it times
        reset_defs = list(dict.fromkeys(kernels.fn_defines(reset_geos[name], PIECES)
                                        for name, _ in RESET_ABLATE_CASES))
        jobs = [(kernel, src, variant, patches,
                 (reset_defs if kernel == "reset" else [fn_def]) if src == "fn_env" else [()])
                for kernel, src, variant, patches in _ablations(repo, chosen)]
        flat = [(src, variant, patches, d) for _, src, variant, patches, defs in jobs for d in defs]
        libs = iter(_patched_libs(repo, kernels, flat)) if flat else iter(())
        for kernel, src, variant, _, defs in jobs:
            for d in defs:
                _load(kernels, next(libs), src, d)
            out.update(time_all(variant, kernel))
            for d in defs:
                kernels._LIBS.pop((src, d))  # back to the unpatched build
        print(json.dumps({"label": args.label, "nvidia_smi": smi, "ablate_ms": out}), flush=True)
        return

    if "fn" in chosen:
        cfg = geos["10x20"]
        for B in FN_B:
            n = 10 if B >= 65536 else 100
            s, a = live(cfg, B)
            keys = batch_keys(prng_key(43), B, device=dev)
            out.update(fn_times(cfg, s, a, f"@10x20@{B}", n))
            out[f"fn_reset@10x20@{B}"] = device_ms(lambda: kernels.fn_reset(keys, cfg, PIECES), n)
            out[f"fn_observe@10x20@{B}"] = device_ms(lambda: kernels.fn_observe(s, cfg, PIECES), n)
            out[f"live_share@{B}"] = float((~s.game_over).float().mean())
            del s, a
        for name in ("30x20", "8x12-pad2"):
            for B in FN_WIDE_B:
                s, a = live(geos[name], B)
                out.update(fn_times(geos[name], s, a, f"@{name}@{B}", 10 if B >= 65536 else 100, frozen=False))
                del s, a
        torch.cuda.empty_cache()
    if "act" in chosen:
        for B in ACT_B:
            out.update(act_times(B, 8, f"@{B}", 100, greedy=B in ACT_GREEDY_B, host=B in ACT_CALL_B))
        for A in ACT_OTHER_A:
            out.update(act_times(1024, A, f"@A{A}@1024", 100, greedy=False))
        out["act_part@board_k4@1024"] = act_part("board", 1024)
        out["act_part@rgb84_k4@512"] = act_part("rgb84", 512)
    if "reset" in chosen:
        for name, B in RESET_CASES:
            out.update(reset_times(name, B, f"@{name}@{B}", 100))
        torch.cuda.empty_cache()
    if "stacked" in chosen:
        for kind, frame, dtype, B in (("pixel", (84, 84), torch.uint8, 512), ("board", (20, 10), torch.int8, 1024)):
            buf = replay_buffer(frame, dtype, B)
            for n in REPLAY_N:
                reps = 5 if (kind == "pixel" and n >= 65536) else 10 if n >= 65536 else 100
                out.update(replay_times(buf, B, n, f"@{kind}@{n}", reps))
            del buf
            torch.cuda.empty_cache()
    if "add" in chosen:
        for kind, B in ADD_CASES:
            buf, blk = add_case(kind, B)
            out.update(add_times(buf, blk, f"@{kind}@{B}", 10 if B >= 65536 else 100))
            del buf, blk
            torch.cuda.empty_cache()
    if "sample" in chosen:
        for kind in ("grouped", "board"):
            buf = sample_case(kind)
            for k, n, with_next in SAMPLE_CASES:
                if k == kind:
                    out.update(sample_times(buf, n, with_next, f"@{kind}@{n}{'' if with_next else '@nonext'}",
                                            10 if n >= 65536 else 100))
            del buf
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "fn_step_builds": list(fn_builds),
                      "replay_builds": list(replay_builds), "builds": builds, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
