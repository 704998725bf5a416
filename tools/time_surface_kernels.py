#!/usr/bin/env python3
"""Device ms of the six surface kernels' default builds (10x20, the 7
standard pieces) at the shapes the earlier slices time them, of the pixel
path's two redesigned kernels, and of the two observation kernels, for the
port found under ``--repo``:

    python tools/time_surface_kernels.py [--repo DIR] [--label NAME] [--ptxas]
                                         [--batches 512,2048,65536] [--ablate]
                                         [--kernels surface|obs|init|sample|wrappers]

``--kernels surface`` (the default): ``grouped_flagship`` features at B =
4096 (``chip_smoke.py`` phase 30), ``grouped_placements`` features at B =
1024 (phase 16), ``feature_vector``, ``observe_dict`` and ``compose_rgb`` at
B = 1, 4096 and 65536 (phase 30); ``render_rgb84`` and ``flagship_step`` (as
the wrapper takes it, and each build of ``kernels.FLAGSHIP_LANES`` where the
tree has them) at B = 512, 2048 and 65536 at 10x20 (phases 24-25, 45-46;
``--batches`` sets these) and at B = 4096 and 65536 at 30x20 and 61x12
(phases 34, 39), beside the launch floor.  With ``--ptxas`` it first builds
``render_rgb84`` and ``flagship_step`` at the three geometries and prints
each build's registers, spills and shared memory.  With ``--ablate`` it
times, in place of all that, the two pixel kernels at 10x20 and
``--batches`` beside patched copies of their sources that each skip one
part (``ABLATIONS``).

``--kernels obs``: ``observe_dict`` (and its strips-only mode, the grouped
rgb mode's) at ``OBS_DICT_SHAPES`` (the Gymnasium shell's B = 1 at 10x20
and 30x20, phases 27 and 37; 4096 and 65536, phases 30 and 39) and
``flagship_observe_board`` at ``OBS_BOARD_SHAPES`` (the flagship
evaluation's 512, ``TetrisVectorEnv``'s 8192 at 10x20 and 30x20, phases 22,
29 and 33; 2048, 4096 and 65536, phases 25 and 34).  ``--ptxas`` builds
``observe_dict.cu`` and ``flagship_step.cu`` at ``OBS_PTXAS`` first;
``--ablate`` times both at 10x20 beside patched copies of the tree's
sources (``OBS_ABLATIONS``: one list for each design, taken by which the
tree holds, with other shapes of the observation).

``--kernels init``: ``flagship_init`` at ``INIT_SHAPES`` (10x20 at B = 1,
a recorded episode; 512, the flagship evaluation; 8192, ``TetrisVectorEnv``,
phase 29; 65536; 30x20 at 4096, 8192, the wide vector env of phase 33, and
65536; 61x12 at 4096 and 65536; 28x14, whose 648-byte board is no multiple
of 16, at 8192 and 65536), each beside its byte bound (the keys read once,
the state written once).  ``--ptxas`` builds ``flagship_step.cu`` at
``OBS_PTXAS`` first; ``--ablate`` times it at 10x20 (``INIT_ABLATE_B``) and
30x20 (``INIT_ABLATE_WIDE_B``) beside patched copies of the tree's source
(``INIT_ABLATIONS``: one list for each design, taken by which the tree
holds).

``--kernels sample``: PPO's rollout step on the flagship engine at
``SAMPLE_SHAPES`` (10x20 at B = 512, 2048 (pixel PPO's batch), 8192 and
65536; 30x20 at 4096): ``flagship_step``'s sampling build (the action
sampled from logits ``f32[B, 8]`` in the step's launch) as the wrapper
takes it and each lanes build, beside the two launches it replaces
(``ppo_sample``, then ``flagship_step``, in one graph), ``ppo_sample``
alone and ``flagship_step`` without the sample (as the wrapper takes it and
each lanes build), each beside its bound (the sample's 40 bytes an env more
than the step's).  ``--ptxas`` builds ``flagship_step.cu`` at
``OBS_PTXAS`` first.

``--kernels wrappers``: the two kernels of the Gymnasium observation
wrappers at ``WRAPPER_SHAPES``: ``feature_vector`` on the wrapper's crop
view of mid-game padded boards (10x20 at B = 1, ``FeatureVectorObservation``
and the grouped wrapper's info, 40, the host mode's candidates, 4096 and
65536; 30x20 at 1, 120, 4096 and 65536; 61x12 at 4096 and 65536) and
``compose_rgb`` on ``observe_dict``'s outputs (the same N; at 40 and 120
the grouped rgb mode's candidates, ``group`` = N, one env's strips), each
beside its byte bound (``feature_vector``: FH * FW bytes read and 4 n
written an env; ``compose_rgb``: H * PW and its share of the strips read,
3 H * IW written an image) and the launch floor of the same call, which is
the bound where it is larger; ``compose_rgb`` also beside its yardstick,
``palette_ext[id_image]``, one indexing call given the composed int64 id
image (``library_ms``).  ``--ptxas`` builds ``features.cu`` at the three
crops and 28x14 and ``observe_dict.cu`` at ``OBS_PTXAS`` first;
``--ablate`` times both at 10x20 (``WRAPPER_ABLATE_B``) beside patched
copies of the tree's sources that skip one part each
(``WRAPPER_ABLATIONS``: the loads, the transpose, the stores, the palette
copy, and the launch alone) or take another shape (no striding warps; one
run length at every N; one-warp blocks).

Each time is taken on mid-game states (40 random steps from a reset), as the
median over 7 replays of a CUDA graph of 100 launches (10 at 65536).  What
the other tree lacks is skipped.  Patched copies are built under
``DIR/build/ablate/``: they compute wrong frames and games by design, only
their times mean anything.  Prints one JSON line with the card's name and
power limit.  To compare two trees on one card, unpack the other into a
directory that ``.gitignore`` lists and run both in one call, in turns: A,
B, B, A.  Needs a card; builds the kernels of ``DIR`` into its own
``build/``.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE_B = (4096, 65536)  # B of the two pixel kernels at 30x20 and 61x12

# --ablate's patched copies: (source, variant, [(text, replacement), ...]).
_NO_STEP = ("    if (!e.game_over) {  // a finished", "    if (false) {  // a finished")
_NO_RESET = ("    if (p.auto_reset && done) {  // the counter", "    if (false) {  // the counter")
_NO_PACK = ("    pack_band(bd, bd_ids);\n",
            "    for (int r = 0; r < Band<L>::R; ++r) for (int j = 0; j < NW; ++j) bd.rows[r][j] = 0u;\n")
_NO_BOARDS = [("  stage_boards_in<", "  if (false) stage_boards_in<"),
              ("  stage_boards_out<", "  if (false) stage_boards_out<")]
ABLATIONS = [
    # what is left: the fields' loads and stores, the boards' staging, the pack
    ("flagship_step", "no_step_no_reset", [_NO_STEP, _NO_RESET]),
    ("flagship_step", "no_step_no_reset_no_pack", [_NO_STEP, _NO_RESET, _NO_PACK]),
    ("flagship_step", "no_step_no_reset_no_boards", [_NO_STEP, _NO_RESET, *_NO_BOARDS]),
    ("flagship_step", "no_pack", [_NO_PACK]),
    ("flagship_step", "no_lock_ids", [("          band_stamp_ids(", "          if (false) band_stamp_ids("),
                                      ("          band_commit_ids(", "          if (false) band_commit_ids(")]),
    ("flagship_step", "no_reset", [_NO_RESET]),
    ("flagship_step", "no_clear", [("const int nl = band_clear_lines(bd, HEIGHT, bits[t], &full);",
                                    "const int nl = 0;")]),
    ("render_rgb84", "no_vertical", [("  if (tid < kQuads * kGroups) {", "  if (false) {")]),
    ("render_rgb84", "no_horizontal", [("  if (band < kBands) {", "  if (false) {")]),
    ("render_rgb84", "no_image", [("cell < H * IW; cell += kThreads", "cell < 0; cell += kThreads")]),
]


# --kernels obs: the shapes (geometry, B) of each kernel, the geometries
# whose builds --ptxas reports, and --ablate's patched copies of each
# design's sources, (source, variant, [(text, replacement), ...]) as above.
OBS_DICT_SHAPES = [("10x20", 1), ("10x20", 4096), ("10x20", 65536), ("30x20", 1), ("30x20", 4096),
                   ("30x20", 65536), ("61x12", 4096), ("61x12", 65536)]
OBS_BOARD_SHAPES = [("10x20", 512), ("10x20", 2048), ("10x20", 8192), ("10x20", 65536), ("30x20", 4096),
                    ("30x20", 8192), ("30x20", 65536), ("61x12", 4096), ("61x12", 65536)]
OBS_DICT_ABLATE_B = (1, 4096, 65536)
OBS_BOARD_ABLATE_B = (512, 2048, 4096, 8192, 65536)
OBS_PTXAS = ("10x20", "30x20", "61x12", "28x14")
OBS_ABLATIONS = {
    # a block of 8 envs staging their boards, a thread an env testing the
    # collision, every board cell reloading the piece (PRs 6-18); the
    # observation's 32 boards and frames staged, a thread an (env, row)
    "block": [
        ("observe_dict", "no_staging",
         [("    block_copy(sboard, p.board", "    if (false) block_copy(sboard, p.board")]),
        ("observe_dict", "no_collision",
         [("      const bool hit = active_collides(", "      const bool hit = false && active_collides(")]),
        ("observe_dict", "no_mask",
         [("      mask_out[base + i] = (r >= y", "      mask_out[base + i] = 0 * (r >= y")]),
        ("observe_dict", "no_strips",
         [("i < n * QSTRIP; i += blockDim.x", "i < 0; i += blockDim.x"),
          ("i < n * HSTRIP; i += blockDim.x", "i < 0; i += blockDim.x")]),
        ("observe_dict", "no_item_piece_word",
         [("      const PieceWord word = piece_word_2d(packed, piece, p.rotation[b]);\n      board_out",
           "      const PieceWord word = no_piece();\n      board_out"),
          ("      const int bx = piece_entry(box, piece);", "      const int bx = S;")]),
        ("observe_dict", "no_board_stores",
         [("      board_out[base + i] = active_cell(", "      if (i < 0) board_out[base + i] = active_cell("),
          ("      mask_out[base + i] = (r >= y", "      if (i < 0) mask_out[base + i] = (r >= y")]),
        ("flagship_step", "obs_no_staging",
         [("  block_copy16(in_s, board + static_cast<size_t>(base) * BOARD, n * BOARD);",
           "  if (false) block_copy16(in_s, board + static_cast<size_t>(base) * BOARD, n * BOARD);")]),
        ("flagship_step", "obs_no_item_piece_word",
         [("    const PieceWord word = game_over[b] ? no_piece() : piece_word_2d(packed, piece[b], rotation[b]);",
           "    const PieceWord word = no_piece();")]),
        ("flagship_step", "obs_no_rows",
         [("item < n * HEIGHT; item += blockDim.x", "item < 0; item += blockDim.x")]),
        ("flagship_step", "obs_no_stores",
         [("  block_copy16(out + static_cast<size_t>(base) * OBS, out_s, n * OBS);",
           "  if (false) block_copy16(out + static_cast<size_t>(base) * OBS, out_s, n * OBS);")]),
    ],
    # a warp an env (observe_dict) or 1-4 envs a warp (the observation),
    # whole words, each env's piece work once, no block-wide barrier
    "warp": [
        ("observe_dict", "no_vote", [("  const uint32_t add = __any_sync(kAll, hit) ? 0u",
                                      "  const uint32_t add = false ? 0u")]),
        ("observe_dict", "no_piece_lookups",
         [("  const PieceWord word = piece_word_lanes(tpacked, subject ? f : -1, rot);",
           "  const PieceWord word = no_piece();")]),
        ("observe_dict", "no_piece_bits",
         [("        const uint32_t pb = piece_bits<WB>(aw, xc, yc, (lane + 32 * k) * WB);",
           "        const uint32_t pb = 0u;"),
          ("        else pb = piece_bits<WB>(aw, xc, yc, i0);", "        else pb = 0u;")]),
        ("observe_dict", "no_mask", [("          m.v[g] = bit_bytes(mb, g);", "          m.v[g] = 0u;")]),
        ("observe_dict", "no_strips", [("  if (lane < S) {  // the queue strip", "  if (false) {  // the queue strip"),
                                       ("  } else if (lane < 2 * S) {  // the holder",
                                        "  } else if (false) {  // the holder")]),
        ("observe_dict", "no_board_stores", [("        store_word<WB>(board_out + base + i0, o);",
                                              "        if (i0 < 0) store_word<WB>(board_out + base + i0, o);"),
                                             ("        store_word<WB>(mask_out + base + i0, m);",
                                              "        if (i0 < 0) store_word<WB>(mask_out + base + i0, m);")]),
        ("flagship_step", "obs_no_piece", [("    pc = over ? -1 : p;", "    pc = -1;")]),
        ("flagship_step", "obs_no_shuffles",
         [("    for (int t = 0; t < TW; ++t) pw.w[t] = __shfl_sync(kAll, word.w[t], src);",
           "    for (int t = 0; t < TW; ++t) pw.w[t] = word.w[t];"),
          ("    const int wn = __shfl_sync(kAll, win, src);", "    const int wn = win;")]),
        ("flagship_step", "obs_no_crop", [("    for (int c = 0; c < WIDTH / G; ++c) to[c] = from[c];",
                                           "    for (int c = 0; c < 0; ++c) to[c] = from[c];")]),
        ("flagship_step", "obs_no_store", [("  for (int q = lane; q < words; q += 32)",
                                            "  for (int q = lane; q < 0; q += 32)")]),
        ("flagship_step", "obs_no_fields", [("  if (lane < n) {\n    const int b = e0 + lane;",
                                             "  if (false) {\n    const int b = e0 + lane;")]),
        ("flagship_step", "obs_no_loads", [("      if ((lane + 32 * k) / NIW < n) in[k] = load(k);",
                                            "      in[k] = Word<WI>{};")]),
        # other shapes, not ablations (their frames are right): one env a
        # warp at every B, never, or up to 32 warps an SM
        ("flagship_step", "obs_envs1", [("constexpr int kObsWarpEnvs = obs_warp_envs();",
                                         "constexpr int kObsWarpEnvs = 1;")]),
        ("flagship_step", "obs_one_env_never", [("constexpr int kObsOneEnvWarpsPerSM = 16;",
                                                 "constexpr int kObsOneEnvWarpsPerSM = 0;")]),
        ("flagship_step", "obs_one_env_to32", [("constexpr int kObsOneEnvWarpsPerSM = 16;",
                                                "constexpr int kObsOneEnvWarpsPerSM = 32;")]),
    ],
}
# --kernels init: the shapes (geometry, B), the batches --ablate takes at
# 10x20 and 30x20, and its patched copies of each design's source, as above.
INIT_SHAPES = [("10x20", 1), ("10x20", 512), ("10x20", 8192), ("10x20", 65536), ("30x20", 4096),
               ("30x20", 8192), ("30x20", 65536), ("61x12", 4096), ("61x12", 65536), ("28x14", 8192),
               ("28x14", 65536)]
INIT_ABLATE_B = (512, 8192, 65536)
INIT_ABLATE_WIDE_B = (8192, 65536)
_STAGED_NO_BOARD = ("    empty_board(boards + t * BOARD);\n", "")
_STAGED_NO_CHAIN = ("    init_env(e, keys[2 * b], keys[2 * b + 1], uniform != 0, box);",
                    "    e = Env{};\n    e.k0 = keys[2 * b];\n    e.k1 = keys[2 * b + 1];")
_STREAM_NO_BOARD = ("  for (int i = si; i < words; i += S) {", "  for (int i = si; i < 0; i += S) {")
_STREAM_NO_CHAIN = ("    init_pieces(e, k.x, k.y, uniform, box);",
                    "    e = Env{};\n    e.k0 = k.x;\n    e.k1 = k.y;")
INIT_ABLATIONS = {
    # a block of 32 envs, a thread an env, each board written byte by byte
    # into shared memory, then the block's boards copied out
    "staged": [
        ("flagship_step", "init_no_board_loop", [_STAGED_NO_BOARD]),
        ("flagship_step", "init_no_chain", [_STAGED_NO_CHAIN]),
        ("flagship_step", "init_no_board_loop_no_chain", [_STAGED_NO_BOARD, _STAGED_NO_CHAIN]),
        ("flagship_step", "init_no_fields", [("    store_env(e, out, b, B);\n  }\n  __syncthreads();",
                                              "    if (b < 0) store_env(e, out, b, B);\n  }\n  __syncthreads();")]),
        ("flagship_step", "init_no_copy",
         [("  block_copy16(out.board + static_cast<size_t>(base) * BOARD, boards, n * BOARD);",
           "  if (n < 0) block_copy16(out.board + static_cast<size_t>(base) * BOARD, boards, n * BOARD);")]),
    ],
    # the boards as a stream of the constant pattern's words beside one RNG
    # chain a thread, the row fields through a warp's tile
    "stream": [
        ("flagship_step", "init_no_board", [_STREAM_NO_BOARD]),
        ("flagship_step", "init_no_chain", [_STREAM_NO_CHAIN]),
        ("flagship_step", "init_no_board_no_chain", [_STREAM_NO_BOARD, _STREAM_NO_CHAIN]),
        ("flagship_step", "init_no_row_fields", [("  __syncwarp();  // the warp's tile of row fields\n",
                                                  "  return;\n")]),
        ("flagship_step", "init_word_each", [("  const bool fixed = S % kPeriod == 0;", "  const bool fixed = false;")]),
        # other shapes (their states are right): every thread streaming
        # first, 128 threads a block, 256 envs a block at every B, the envs
        # shared evenly among the fewest blocks an SM
        ("flagship_step", "init_no_split", [("const int first = env_warps <= kInitWarps - 2 ? 32 * env_warps : 0;",
                                             "const int first = 0;")]),
        ("flagship_step", "init_threads128", [("constexpr int kInitThreads = 256;", "constexpr int kInitThreads = 128;")]),
        ("flagship_step", "init_envs_full", [("  return std::min(kInitThreads, std::max(1, (B + sms - 1) / sms));",
                                              "  return kInitThreads;")]),
        ("flagship_step", "init_envs_even", [("  return std::min(kInitThreads, std::max(1, (B + sms - 1) / sms));",
                                              "  const int per_sm = (B + sms * kInitThreads - 1) / (sms * kInitThreads);\n"
                                              "  return std::max(1, (B + sms * per_sm - 1) / (sms * per_sm));")]),
        # the launch alone: every thread returns at once
        ("flagship_step", "init_empty", [("  extern __shared__ int32_t tiles[];  // 32 * kRowInts words a warp\n",
                                          "  if (B > 0) return;\n  extern __shared__ int32_t tiles[];  // 32 * kRowInts words a warp\n")]),
    ],
}
# --kernels sample: the shapes (geometry, B)
SAMPLE_SHAPES = [("10x20", 512), ("10x20", 2048), ("10x20", 8192), ("10x20", 65536), ("30x20", 4096)]
# --kernels wrappers: the shapes (kernel, geometry, B) and --ablate's B and
# patched copies (features.cu's and observe_dict.cu's compose_rgb), as above
WRAPPER_SHAPES = [(k, "10x20", B) for k in ("feature_vector", "compose_rgb") for B in (1, 40, 4096, 65536)] \
    + [(k, "30x20", B) for k in ("feature_vector", "compose_rgb") for B in (1, 120, 4096, 65536)] \
    + [(k, "61x12", B) for k in ("feature_vector", "compose_rgb") for B in (4096, 65536)]
WRAPPER_ABLATE_B = (1, 40, 4096, 65536)
WRAPPER_ABLATIONS = {
    "features": [
        ("features", "no_loads", [("  for (int q = 0; q < NWW; ++q) w[q] = live && 16 * q < off + FW ? __ldg(a + q) : make_uint4(0u, 0u, 0u, 0u);",
                                   "  for (int q = 0; q < NWW; ++q) w[q] = make_uint4(static_cast<uint32_t>(p) + q, 0u, 0u, 0u);")]),
        ("features", "no_transpose", [("    for (int k = 0; k < NWF; ++k) col[j][k] = transpose32(m[j][k], lane);",
                                       "    for (int k = 0; k < NWF; ++k) col[j][k] = m[j][k];")]),
        ("features", "no_stores", [("      if (lane + 32 * k < FW) o[lane + 32 * k] = h[k];",
                                    "      if (lane + 32 * k < FW && h[k] < 0) o[lane + 32 * k] = h[k];"),
                                   ("  if (lane == 0 && (flags & kMaxHeight)) o[i_max] = max_h;",
                                    "  if (lane == 0 && (flags & kMaxHeight) && max_h < 0) o[i_max] = max_h;"),
                                   ("  if (lane == 1 && (flags & kHoles)) o[i_holes] = holes;",
                                    "  if (lane == 1 && (flags & kHoles) && holes < 0) o[i_holes] = holes;"),
                                   ("  if (lane == 2 && (flags & kBumpiness)) o[i_bump] = bump;",
                                    "  if (lane == 2 && (flags & kBumpiness) && bump < 0) o[i_bump] = bump;")]),
        ("features", "empty", [("(threadIdx.x >> 5); b < B; b += gridDim.x * warps)", "(threadIdx.x >> 5); b < 0; b += gridDim.x * warps)")]),
        # another shape (its vectors are right): a block for every 8 envs, no striding
        ("features", "no_stride", [("constexpr int kBlocksPerSM = 8;", "constexpr int kBlocksPerSM = 1 << 20;")]),
    ],
    "compose": [
        ("observe_dict", "no_loads", [("    id[i] = __ldg(base + index);", "    id[i] = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(base + index) & 15);")]),
        ("observe_dict", "no_palette_copy", [("  for (int t = lane; t < kPal; t += 32) table[t]", "  for (int t = lane; t < 0; t += 32) table[t]")]),
        ("observe_dict", "no_stores", [("    if (q < words) store_word<RN::SW>(", "    if (q < words && w[0] == 0x5A5A5A5Au) store_word<RN::SW>(")]),
        ("observe_dict", "empty", [("  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;\n  const bool live",
                                    "  if (runs > 0) return;\n  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;\n  const bool live")]),
        # other shapes (their images are right): 16-pixel runs at every N, a
        # pixel a lane at every N, blocks of one warp spread over the SMs
        ("observe_dict", "runs16", [("Run<16>::RUNS < static_cast<long long>(kSmallRunsPerSM) * sm_count() ? 1 : 16;",
                                     "Run<16>::RUNS < 0 ? 1 : 16;")]),
        ("observe_dict", "runs1", [("Run<16>::RUNS < static_cast<long long>(kSmallRunsPerSM) * sm_count() ? 1 : 16;",
                                    "Run<16>::RUNS < 0 ? 16 : 1;")]),
        ("observe_dict", "spread_warps", [("int compose_warps(int runs) { return std::min(kComposeWarps, (runs + 31) / 32); }",
                                           "int compose_warps(int runs) { return std::min(kComposeWarps, std::max(1, ((runs + 31) / 32 + sm_count() - 1) / sm_count())); }")]),
    ],
}
# which kernels a patched source changes
_ABLATED_KERNELS = {"features": ("feature_vector",), "compose": ("compose_rgb",),
                    "observe_dict": ("observe_dict",),
                    "flagship_step": ("flagship_step", "flagship_observe_board", "flagship_init"),
                    "render_rgb84": ("render_rgb84",)}


def _patched(csrc, source, patches):
    with open(os.path.join(csrc, f"{source}.cu")) as f:
        text = f.read()
    for old, new in patches:
        if old not in text:
            return None
        text = text.replace(old, new)
    return text


def ablate(repo, kernels, defines, cases, time_fn, ablations, ablated=None) -> dict:
    """Device ms of each copy of ``ablations`` and of the unpatched build
    ("full") on each ``label: case`` of ``cases``, made beforehand by the
    unpatched build; ``time_fn(case)`` gives ``{kernel: ms}`` as the loaded
    libraries have them, and a copy's times are those of the kernels of
    its source (``_ABLATED_KERNELS``)."""
    csrc = os.path.join(repo, "tetris_gymnasium_torch", "csrc")

    def build(job):
        source, variant, patches = job
        text = _patched(csrc, source, patches)
        if text is None:
            raise SystemExit(f"time_surface_kernels: {source}.cu no longer holds a patch of {variant}")
        tag = "_".join(str(v) for _, v in defines)  # a library of its own a geometry
        d = os.path.join(repo, "build", "ablate", f"{source}_{variant}_{tag}")
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

    with ThreadPoolExecutor(max_workers=len(ablations)) as pool:
        libs = list(pool.map(build, ablations))
    out = {}
    for label, case in cases.items():
        out.update({f"{k}_full@{label}": v for k, v in time_fn(case).items()})
    for (source, variant, _), so in zip(ablations, libs):
        lib = ctypes.CDLL(so)
        for fn, argtypes in kernels._ENTRY_POINTS[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernels._LIBS[(source, defines)] = lib
        for label, case in cases.items():
            out.update({f"{k}_{variant}@{label}": v for k, v in time_fn(case).items()
                        if k.startswith(ablated or _ABLATED_KERNELS[source])})
        kernels._LIBS.pop((source, defines))  # back to the unpatched build
    return out


def design_ablations(repo, lists=None):
    """The list of ``lists`` (``OBS_ABLATIONS`` or ``INIT_ABLATIONS``) whose
    patches all apply to the tree at ``repo``."""
    csrc = os.path.join(repo, "tetris_gymnasium_torch", "csrc")
    for design, jobs in (OBS_ABLATIONS if lists is None else lists).items():
        if all(_patched(csrc, src, patches) is not None for src, _, patches in jobs):
            return design, jobs
    raise SystemExit("time_surface_kernels: no list of ablations matches the sources")


def build_facts(kernels, jobs) -> dict:
    """Builds ``(label, source, defines)`` in parallel; each one's nvcc
    seconds and ptxas lines (registers, spills, shared memory)."""
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        facts = list(pool.map(lambda job: kernels._compile(job[1], job[2]), jobs))
    return {f"{src}@{name}": {"seconds": f["seconds"], "extra_flags": f.get("extra_flags"),
                              "ptxas": [l.strip() for l in f["ptxas"].splitlines()
                                        if "registers" in l or "spill" in l or "Compiling" in l]}
            for (name, src, _), f in zip(jobs, facts)}


def init_main(args, repo, kernels, geos, P, defines, smi, builds) -> None:
    """``--kernels init``: ``flagship_init``'s device ms at ``INIT_SHAPES``
    beside its byte bound, or with ``--ablate`` its patched copies'."""
    from chip_smoke import device_ms
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    dev = torch.device("cuda")

    def case(name, B):
        return geos[name], batch_keys(prng_key(20 + B), B, device=dev)

    def time_init(c):
        cfg, keys = c
        n = 10 if keys.shape[0] >= 65536 else 100
        return {"flagship_init": device_ms(lambda: kernels.flagship_init(keys, cfg, P), n)}

    if args.ablate:
        design, jobs = design_ablations(repo, INIT_ABLATIONS)
        out = {}
        for name, batches in (("10x20", INIT_ABLATE_B), ("30x20", INIT_ABLATE_WIDE_B)):
            res = ablate(repo, kernels, defines(name), {f"{name}@{B}": case(name, B) for B in batches},
                         time_init, jobs)
            out.update(res)
        print(json.dumps({"label": args.label, "repo": repo, "design": design, "nvidia_smi": smi,
                          "ablate_ms": out}), flush=True)
        return
    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    for name, B in INIT_SHAPES:
        c = case(name, B)
        s = kernels.flagship_init(c[1], c[0], P)
        io = c[1].numel() * 4 + sum(getattr(s, k).numel() * getattr(s, k).element_size() for k in engine.FIELDS)
        out[f"flagship_init@{name}@{B}"] = time_init(c)["flagship_init"]
        out[f"bound@{name}@{B}"] = 1e3 * io / 3.35e12
        del s
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "builds": builds, "ms": out}),
          flush=True)


def sample_main(args, repo, kernels, geos, P, rw, smi, builds, states) -> None:
    """``--kernels sample``: the flagship sampling step's device ms at
    ``SAMPLE_SHAPES`` beside the pair it replaces, ``ppo_sample`` and the
    step without the sample."""
    import inspect

    from chip_smoke import _flagship_actions, device_ms, nbytes
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.threefry import prng_key

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    sampled = "logits" in inspect.signature(kernels.flagship_step).parameters
    lanes_builds = getattr(kernels, "FLAGSHIP_LANES", ())
    key = prng_key(7)
    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    for name, B in SAMPLE_SHAPES:
        c = geos[name]
        n = 10 if B >= 65536 else 100
        s = states(B, c)
        a = _flagship_actions(B, g, dev)
        x = torch.randn((B, 8), generator=g, device=dev) * 3
        step_bytes = 2 * nbytes(*(getattr(s, k) for k in engine.FIELDS)) + nbytes(a) + B * (4 + 1 + 4)
        tag = f"{name}@{B}"
        out[f"ppo_sample@{tag}"] = device_ms(lambda: kernels.sample_actions(x, key), n)
        out[f"ppo_sample_then_flagship_step@{tag}"] = device_ms(
            lambda: kernels.flagship_step(s, kernels.sample_actions(x, key)[0], c, P, rw), n)
        out[f"flagship_step@{tag}"] = device_ms(lambda: kernels.flagship_step(s, a, c, P, rw), n)
        for L in lanes_builds:
            out[f"flagship_step_lanes{L}@{tag}"] = device_ms(
                lambda: kernels.flagship_step(s, a, c, P, rw, lanes=L), n)
        if sampled:
            out[f"sample_step@{tag}"] = device_ms(
                lambda: kernels.flagship_step(s, None, c, P, rw, logits=x, act_key=key), n)
            for L in lanes_builds:
                out[f"sample_step_lanes{L}@{tag}"] = device_ms(
                    lambda: kernels.flagship_step(s, None, c, P, rw, lanes=L, logits=x, act_key=key), n)
        out[f"step_bound@{tag}"] = 1e3 * step_bytes / 3.35e12
        out[f"sample_step_bound@{tag}"] = 1e3 * (step_bytes - nbytes(a) + nbytes(x) + 8 * B) / 3.35e12
        del s, a, x
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "flagship_lanes": list(lanes_builds),
                      "builds": builds, "ms": out}), flush=True)


def wrappers_main(args, repo, kernels, geos, P, rw, defines, smi) -> None:
    """``--kernels wrappers``: ``feature_vector`` and ``compose_rgb`` at
    ``WRAPPER_SHAPES`` beside their bounds, the floor and, for
    ``compose_rgb``, ``palette_ext[id_image]``; or with ``--ablate`` their
    patched copies' times at 10x20."""
    from chip_smoke import _flagship_actions, device_ms
    from tetris_gymnasium_torch.ops.observations import FeatureFlags
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    flags = FeatureFlags()
    crops = {"10x20": (20, 10), "30x20": (20, 30), "61x12": (12, 61), "28x14": (14, 28)}
    builds = {}
    if args.ptxas:
        builds = build_facts(kernels, [(n, "features", kernels.feature_defines(*crops[n])) for n in crops]
                             + [(n, "observe_dict", defines(n)) for n in OBS_PTXAS])
    build_facts(kernels, [(n, "features", kernels.feature_defines(*crops[n])) for n in ("10x20", "30x20", "61x12")]
                + [(n, src, defines(n)) for n in ("10x20", "30x20", "61x12") for src in ("observe_dict", "flagship_step")])

    def case(name, B):
        """The kernels' inputs at ``name`` for B envs (N images): mid-game
        boards' crop view, and observe_dict's outputs, one env's strips
        where B is the candidates' count (the grouped rgb mode)."""
        cfg = geos[name]
        s = kernels.flagship_init(batch_keys(prng_key(22 + B), B, device=dev), cfg, P)
        for _ in range(40):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, rw)[0]
        d = kernels.observe_dict(s, cfg, P)
        group = B if B in (40, 120) else 1
        pad = cfg.padding
        return {"cfg": cfg, "crop": s.board[:, :-pad, pad:-pad], "board": d["board"], "group": group,
                "queue": d["queue"][: B // group].contiguous(), "holder": d["holder"][: B // group].contiguous()}

    def time_case(kernel, c):
        n = 10 if c["board"].shape[0] >= 65536 else 100
        if kernel == "feature_vector":
            return {kernel: device_ms(lambda: kernels.feature_vector(c["crop"], flags), n)}
        return {kernel: device_ms(lambda: kernels.compose_rgb(c["board"], c["queue"], c["holder"], P, c["group"]), n)}

    if args.ablate:
        design = "warp" if "transpose32" in open(os.path.join(repo, "tetris_gymnasium_torch", "csrc",
                                                             "features.cu")).read() else "thread"
        if design != "warp":
            raise SystemExit("time_surface_kernels: --kernels wrappers --ablate patches this PR's design only")
        cases = {f"10x20@{B}": case("10x20", B) for B in WRAPPER_ABLATE_B}
        out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
        for kernel, key, defs in (("feature_vector", "features", kernels.feature_defines(20, 10)),
                                  ("compose_rgb", "compose", defines("10x20"))):
            jobs = [(src, variant, patches) for src, variant, patches in WRAPPER_ABLATIONS[key]]
            res = ablate(repo, kernels, defs, cases, lambda c, k=kernel: time_case(k, c),
                         [(src, v, p) for src, v, p in jobs], ablated=_ABLATED_KERNELS[key])
            out.update({k: v for k, v in res.items() if k.startswith(kernel)})
        print(json.dumps({"label": args.label, "repo": repo, "design": design, "nvidia_smi": smi,
                          "ablate_ms": out}), flush=True)
        return
    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    for kernel, name, B in WRAPPER_SHAPES:
        c = case(name, B)
        cfg = c["cfg"]
        FH, FW = c["crop"].shape[1:]
        tag = f"{kernel}@{name}@{B}"
        out[tag] = time_case(kernel, c)[kernel]
        if kernel == "feature_vector":
            io = B * (FH * FW + 4 * (FW + 3))
        else:
            H, PW = c["board"].shape[1:]
            iw = PW + max(c["queue"].shape[2], c["holder"].shape[2])
            io = B * (H * PW + 3 * H * iw) + c["queue"].numel() + c["holder"].numel()
            # the yardstick: one indexing call given the composed int64 id image
            out[f"library@{name}@{B}"] = _compose_library_ms()(c["board"], c["queue"], c["holder"], c["group"], P,
                                                               10 if B >= 65536 else 100)
        out[f"bound_bytes@{tag}"] = 1e3 * io / 3.35e12
        out[f"bound@{tag}"] = max(out[f"bound_bytes@{tag}"], out["floor"])
        del c
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "builds": builds, "ms": out}),
          flush=True)


def _compose_library_ms():
    """``compose_rgb``'s yardstick, ``compose_library_ms`` of this tree's
    ``chip_smoke.py``: the tree that ``--repo`` names may predate it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_yardstick", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.compose_library_ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--batches", default="512,2048,65536",
                    help="B of the two pixel kernels at 10x20")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--kernels", choices=("surface", "obs", "init", "sample", "wrappers"), default="surface")
    args = ap.parse_args()
    pixel_b = tuple(int(x) for x in args.batches.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("time_surface_kernels: needs a CUDA card")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from chip_smoke import _flagship_actions, _grouped_actions, device_ms
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops import bitboard as bb
    from tetris_gymnasium_torch.ops.observations import FeatureFlags
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    P, rw = engine.PIECES, RewardsMapping()
    geos = {"10x20": EngineConfig(auto_reset=True),
            "30x20": EngineConfig(width=30, height=20, auto_reset=True),
            "61x12": EngineConfig(width=61, height=12, queue_size=3, auto_reset=True),
            "28x14": EngineConfig(width=28, height=14, auto_reset=True)}

    def defines(name):
        return kernels.engine_defines(geos[name], bb.turbo_tables(P), flagship=True)

    builds = {}
    if args.kernels == "wrappers":
        wrappers_main(args, repo, kernels, geos, P, rw, defines, smi)
        return
    if args.ptxas:
        names, sources = {"obs": (OBS_PTXAS, ("observe_dict", "flagship_step")),
                          "init": (OBS_PTXAS, ("flagship_step",)),
                          "sample": (OBS_PTXAS, ("flagship_step",))}.get(
            args.kernels, (("10x20", "30x20", "61x12"), ("render_rgb84", "flagship_step")))
        builds = build_facts(kernels, [(n, src, defines(n)) for n in names for src in sources])
    if args.kernels == "init":
        build_facts(kernels, [(n, "flagship_step", defines(n)) for n in geos])
        init_main(args, repo, kernels, geos, P, defines, smi, builds)
        return
    if args.kernels == "sample":
        build_facts(kernels, [(n, "flagship_step", defines(n)) for n in ("10x20", "30x20")]
                    + [("any", "ppo_sample", ())])
    elif args.kernels == "obs":
        build_facts(kernels, [(n, src, defines(n)) for n in ("10x20", "30x20", "61x12")
                              for src in ("observe_dict", "flagship_step")])
    else:
        kernels.build([] if args.ablate else [(geos["30x20"], P), (geos["61x12"], P)])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(30)
    cfg, flags = geos["10x20"], FeatureFlags()
    lanes_builds = getattr(kernels, "FLAGSHIP_LANES", ())
    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}

    def flagship_states(B, c=cfg):
        s = kernels.flagship_init(batch_keys(prng_key(30 + B), B, device=dev), c, P)
        for _ in range(40):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), c, P, rw)[0]
        return s

    if args.kernels == "sample":
        sample_main(args, repo, kernels, geos, P, rw, smi, builds, flagship_states)
        return
    if args.kernels == "obs":
        def time_obs(case):
            kind, c, s = case
            n = 10 if s.piece.shape[0] >= 65536 else 100
            if kind == "dict":
                return {"observe_dict": device_ms(lambda: kernels.observe_dict(s, c, P), n),
                        "observe_dict_strips": device_ms(
                            lambda: kernels.observe_dict(s, c, P, strips_only=True), n)}
            return {"flagship_observe_board": device_ms(lambda: kernels.flagship_observe_board(s, c, P), n)}

        if args.ablate:
            design, jobs = design_ablations(repo)
            cases = {**{f"dict@{B}": ("dict", cfg, flagship_states(B)) for B in OBS_DICT_ABLATE_B},
                     **{f"board@{B}": ("board", cfg, flagship_states(B)) for B in OBS_BOARD_ABLATE_B}}
            out = ablate(repo, kernels, defines("10x20"), cases, time_obs, jobs)
            print(json.dumps({"label": args.label, "repo": repo, "design": design, "nvidia_smi": smi,
                              "ablate_ms": out}), flush=True)
            return
        for name, B in sorted(set(OBS_DICT_SHAPES) | set(OBS_BOARD_SHAPES), key=lambda x: (x[0], x[1])):
            s = flagship_states(B, geos[name])
            if (name, B) in OBS_DICT_SHAPES:
                out.update({f"{k}@{name}@{B}": v for k, v in time_obs(("dict", geos[name], s)).items()})
            if (name, B) in OBS_BOARD_SHAPES:
                out.update({f"{k}@{name}@{B}": v for k, v in time_obs(("board", geos[name], s)).items()})
            del s
        print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "builds": builds, "ms": out}),
              flush=True)
        return
    if args.ablate:
        def time_both(case):
            s, a = case
            n = 10 if a.shape[0] >= 65536 else 100
            return {"render_rgb84": device_ms(lambda: kernels.render_rgb84(s, cfg, P), n),
                    **{f"flagship_step_lanes{L}": device_ms(
                        lambda: kernels.flagship_step(s, a, cfg, P, rw, lanes=L), n)
                       for L in lanes_builds}}

        cases = {B: (flagship_states(B), _flagship_actions(B, g, dev)) for B in pixel_b}
        out = ablate(repo, kernels, defines("10x20"), cases, time_both, ABLATIONS)
        print(json.dumps({"label": args.label, "nvidia_smi": smi, "builds": builds, "ablate_ms": out}),
              flush=True)
        return
    for B in (1, 4096, 65536):
        n = 10 if B >= 65536 else 100
        s = flagship_states(B)
        d = kernels.observe_dict(s, cfg, P)
        crop = s.board[:, :20, 4:14]
        out[f"feature_vector@{B}"] = device_ms(lambda: kernels.feature_vector(crop, flags), n)
        out[f"observe_dict@{B}"] = device_ms(lambda: kernels.observe_dict(s, cfg, P), n)
        out[f"compose_rgb@{B}"] = device_ms(
            lambda: kernels.compose_rgb(d["board"], d["queue"], d["holder"], P), n)
        if B == 4096:
            out[f"grouped_flagship_features@{B}"] = device_ms(
                lambda: kernels.grouped_flagship(s, cfg, P, "features"), n)
        del s, d, crop
    # the pixel path's two kernels, each flagship_step build where the tree has them
    for name, c in geos.items():
        for B in (pixel_b if name == "10x20" else WIDE_B):
            n = 10 if B >= 65536 else 100
            s = flagship_states(B, c)
            a = _flagship_actions(B, g, dev)
            out[f"render_rgb84@{name}@{B}"] = device_ms(lambda: kernels.render_rgb84(s, c, P), n)
            out[f"flagship_step@{name}@{B}"] = device_ms(
                lambda: kernels.flagship_step(s, a, c, P, rw), n)
            for L in lanes_builds:
                out[f"flagship_step_lanes{L}@{name}@{B}"] = device_ms(
                    lambda: kernels.flagship_step(s, a, c, P, rw, lanes=L), n)
            del s, a
    gcfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    gs, _ = tg.reset(batch_keys(prng_key(1), 1024, device=dev), gcfg, device=dev)
    for _ in range(20):
        gs = tg.step(gs, _grouped_actions(gs, g, dev, wild=0.0), gcfg)[0]
    out["grouped_placements_features@1024"] = device_ms(
        lambda: kernels.grouped_placements(gs.env, gcfg, turbo.PIECES, 4, "features"), 100)
    print(json.dumps({"label": args.label, "repo": os.path.abspath(args.repo), "nvidia_smi": smi,
                      "flagship_lanes": list(lanes_builds), "builds": builds, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
