#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``); no card fails.
2. build: every CUDA kernel of ``tetris_gymnasium_torch/csrc`` with ``nvcc``.
3. ``turbo_step`` and ``turbo_init`` against their plain PyTorch versions on
   the card, bit for bit, over random-action rollouts (B = 4096 with
   auto-reset; B = 4096 without gravity and with custom rewards; B = 512,
   the evaluation's shape; uniform pieces; B = 1001, a ragged last block,
   and B = 1) and hand-built boards with up to six full rows: every build of
   ``turbo_step`` (each lanes count of ``kernels.STEP_LANES``, without and
   with the board observation written in the same launch, held to
   ``observe_board_plain`` of the returned state).  Then the sampling builds
   (PPO's rollout step: the action sampled from logits in the launch, 1 and
   8 lanes) at B = 8192, 4096, 1001 and 1, 16 steps each under logits
   scaled x0.1, x3, x30 and exact ties: actions, state, observation,
   reward, done and lines bit-equal to ``sample_actions_plain`` +
   ``step_plain`` + ``observe_board_plain``, log-probs within
   ``LOG_PROB_ULPS`` of the plain one and bit-equal to ``ppo_sample``'s.
   ``turbo_init`` also from the state's ``[2, B]`` key (``key_rows``, as
   ``turbo.init_from_key`` passes it) at B = 1, 33, 1001, 1024, 8192 and at
   batches that leave part-full blocks (``turbo_init_diff``; in phase 31 at
   every geometry, in phase 34 at every timed batch).
4. ``observe_board`` against its plain version on every state of phase 3.
5. The main path: the committed PPO policy (``results/ppo_lines_params.npz``,
   bf16 trunk) plays 512 greedy games of at most 2000 steps through
   ``rl.evaluate.evaluate_policy``; every kernel's launch count is read
   (each step one ``turbo_step`` launch that writes the observation,
   ``observe_board`` once for the first).  A small fp32 evaluation on the
   card must equal the same evaluation run by the plain versions on the CPU.
6. The least launch the card takes (a CUDA graph of ``torch.cuda._sleep(0)``)
   and a copy of 8192 floats (the least for a kernel that reads and writes
   once), then times with CUDA events at the evaluation's shape (B = 512), the
   training's (B = 8192), the grouped training's (B = 1024, gravity off) and
   B = 65536, beside each kernel's byte bound at 3.35 TB/s: ``turbo_step``
   without and with the observation (the wrapper's lanes, and each build).
7. ``gae`` against ``rl.ppo.gae_plain`` (bit-equal), both builds (TMA
   tensor copies where B % 16 == 0, cp.async everywhere) at T = 1, 7, 128, 129,
   512 and B = 1, 16, 1001, 8192, 65536 with p_done 0, 1/200 and 1, and
   ``ppo_sample`` against ``rl.ppo.sample_actions_plain`` (uniforms
   bit-equal, actions equal, log-probs within ``LOG_PROB_ULPS``) at the
   training's shapes and at ragged ones.
8. A small fp32 PPO train step (64 envs, 8 steps, 2 epochs of 2
   minibatches, the committed weights) on the card against the same step on
   the CPU: rollouts bit-equal, each parameter leaf's change within
   ``SMALL_TRAIN_PARAM_TOL`` of its norm.
9. The training path: ``examples/train_ppo.py``'s code warm-starts from the
   committed weights at 8192 envs x 128 steps, 6 epochs of 8 minibatches,
   bf16 trunk, lr 4e-5, ent-coef 0.004, for 3 train steps; every kernel's
   launch count is read (each rollout step one ``turbo_step`` launch that
   samples the action, steps and writes the observation; ``ppo_sample``
   0), the metrics must be finite and the weights must
   move, and 512 greedy games of the trained weights must still clear 9.5
   lines each.  On the first minibatch of one more rollout, the training
   update must lower that minibatch's loss, and the clipped surrogate must
   be lower a small step down its gradient than a step up it (the sign of
   the gradient).  The train step's time is split into rollout, GAE and update
   with CUDA events, and one minibatch's into gather, forward, backward and
   optimizer.
10. Times at B = 2048, 8192 and 65536 beside their bounds and the launch
    floor: ``gae`` (T = 128, the wrapper's build and both), ``ppo_sample``,
    the sampling step (the wrapper's lanes and both) and the two launches
    it replaces (``ppo_sample``, then ``turbo_step`` with the observation).
    The flagship routes' sampling step (``flagship_step`` sampling and
    stepping in one launch, the wrapper's lanes and both) beside the two
    launches it replaces (``ppo_sample``, then ``flagship_step``).
    ``gae`` and the sampling steps are timed twice: on inputs the previous
    launch left in the L2, and on inputs read from HBM (``cold_ms``: a read
    of 128 MiB before each launch, its own time taken off), as the path
    gives them after the policy's forward pass.

11. ``grouped_placements`` against its plain versions, features and boards,
    bit for bit: random-placement grouped trajectories (one action in ten
    uniform over all candidates, so some are illegal) at B = 4096 with
    auto-reset under both ``terminate_on_illegal`` settings and at B = 512
    without auto-reset, and hand-built boards with up to six full rows at
    ``max_clear`` 4 and 20.
12. ``grouped_act`` against ``rl.grouped_dqn.act_plain`` (actions equal; the
    uniforms behind the noise and the exploration draw bit-equal to JAX's
    mapping) at B = 1024, 4096, 1 and 1001 with envs that have no legal
    candidate, near-ties and NaNs, as the wrapper picks its lanes and at
    every width of ``kernels.GROUPED_ACT_LANES``, and ``replay_sample``'s offsets against JAX's ``randint``
    (card and host) for spans 1 .. 2**31 - 1.
13. ``replay_add`` and ``replay_sample`` against the plain buffer, bit for
    bit, across the buffer's wrap-around; ``replay_sample`` also at n = 1,
    3, 256, 512 and 65536 with and without successors, its offsets against
    the host's randint (``REPLAY_EDGE_N``; in phases 15 and 19 too, on the
    full buffers).
14. A small fp32 grouped DQN (64 envs, the micro-gate configuration of
    ``tests/test_learning.py`` on the 10x20 board, 70 steps: learning from
    step 64 and a target sync) on the card and on the CPU from the same
    weights: replay contents and env states bit-equal, each parameter
    leaf's change within ``SMALL_GROUPED_PARAM_TOL`` of its norm; a 64-episode ``evaluate_grouped`` of
    the card's weights gives equal statistics on both.
15. The grouped training path: ``examples/train_lin_grouped.py``'s code at
    the committed run's shape (1024 envs, ``QMLP``, buffer 131,072, batch
    256, features) for 2000 steps; exact launch counts, finite metrics,
    weights that move, the learning gate of ``tests/test_learning.py:136-141``
    over 50-step chunks, the step split into act, env step, replay add,
    sample + update and target sync with CUDA events, a 512-episode greedy
    ``evaluate_grouped`` of the trained and the untrained net, and the card's
    busy share over 20 more steps traced by ``torch.profiler``.  Then the
    kernels at the shapes this path gives them, on the trained state, bit
    for bit: ``grouped_placements`` on its 1024 envs in both modes, one
    grouped step (some pieces teleported into the bedrock) against the same
    step on a CPU copy, and ``replay_add`` and ``replay_sample`` on the full
    131,072-entry buffer against their plain versions.
16. The grouped kernels' times beside their bounds (``grouped_placements``
    in both modes at B = 512, 1024, 4096 and 65536; ``grouped_act`` at 1024
    and 4096, each lane width held to its plain version and timed, its
    greedy launch beside ``torch.where`` + ``argmax``; ``replay_add`` at 1024
    beside the obs field's ``copy_``; ``replay_sample`` at 256
    samples of the full buffer, with its launch's shape), ``turbo_init`` as
    the grouped step re-initialises (``turbo.init_from_key`` on the state's
    key, B = 1024) and the grouped step's placements per second.

17. ``framestack_push`` against ``ops.framestack.push_plain`` (random
    windows, ~15% ``done``, B = 1024 and 512 with K = 4, B = 1 and 1001 with
    K = 2), ``replay_sample_stacked`` against
    ``rl.buffers.sample_with_next_stacked_plain`` on buffers that wrap
    twice, filled through the strided newest-frame view of a window (so
    ``replay_add`` reads strided rows), with its offsets equal to JAX's
    ``randint`` (card and host), and ``dqn_act`` against
    ``rl.dqn.act_plain`` at B = 1024, 1 and 1001: actions equal, the randint
    and uniform draws bit-equal.
18. A small fp32 CNN DQN (64 envs, K = 4, buffer 64 x 16, batch 32, learning
    from step 8, a target sync every 16, 40 steps) on the card and on the
    CPU from the same weights: replay contents, env states and the window
    bit-equal, each parameter leaf's change within ``SMALL_DQN_PARAM_TOL``
    of its norm.
19. The CNN DQN path: ``examples/train_cnn.py``'s code at the committed runs'
    shape (1024 envs, buffer 262,144, batch 512, lr 1e-4, target sync every
    500, ``QNetworkCNN`` with a bf16 trunk) and schedule (epsilon over
    10,000 steps, learning from step 1000) for 2000 steps, K = 4 and then
    K = 1, from the JAX runs' initial weights
    (``results/qcnn*_init_seed1.npz``).  Each: exact launch
    counts (the observations from ``turbo_step``'s launches), finite
    metrics, weights that move, the learning gate (mean reward per env step
    over steps 1751-2000 at least ``DQN_GATE`` times the mean over steps
    1-500) beside the committed JAX curve, the step split
    (act, env step with observe and push, replay add, sample + update, sync)
    with CUDA events, a 512-episode greedy ``evaluate_q_checkpoint`` (at most
    2000 steps, seed 0) of the trained and the untrained net, the card's
    busy share over 20 more steps, and then every kernel of the path against
    its plain version on the trained state at the path's shapes (B = 1024,
    the full wrapped 262,144-entry buffer).
20. The new kernels' times beside their bounds, at the path's shapes and at
    B = 65536, and the DQN path's replay kernels at its shapes
    (``replay_add`` beside the obs field's ``copy_``); ``dqn_act``'s
    greedy launch (the evaluations' argmax) beside ``torch.argmax(q, -1)``
    (also at B = 512 in phase 25), its ``call_ms`` with keys (a Python
    call's host time: the key's split is made on the card); before the
    times, every ``dqn_act`` build (A = 8, and the build for any other A at
    A = 5 and 40) bit-equal to ``act_plain`` on rows with NaNs, ties and
    +-inf, with keys (and its draws) at global counter offsets 0, B and 3B
    and greedy (:func:`dqn_act_builds_diff`; also in phases 25 and 48).

21. The flagship engine: ``flagship_init`` against ``core.engine.init_plain``
    at B = 512, 1 and 1001 (bag and uniform) and at the edges of its blocks
    (``init_edges_diff``: B = 1, 31, 33, part-full last blocks of a few
    envs and of 256, and 8192; in phase 31 at every geometry, in phases
    29, 33 and 34 at the vector env's 8192), and ``flagship_step`` against
    ``step_plain`` along 300-step random trajectories biased towards hard
    drops and swaps (B = 512 with auto-reset, B = 512 without gravity or
    auto-reset and with custom rewards, B = 1001 uniform with auto-reset,
    B = 1 uniform), bit for bit, with full holders and game-over frames;
    each trajectory equal to ``turbo_step``'s on the same keys and actions
    (occupancy, piece, bag, queue, holder, score, lines, reward, done); and
    300 steps from hand-built stacks with up to six full rows, which clear
    more rows at once than the turbo engine's envelope; every build of
    ``flagship_step`` (each lanes count of ``kernels.FLAGSHIP_LANES``,
    ``flagship_builds_diff``) at every step.  Then the sampling builds of
    ``flagship_step`` (PPO's rollout step on the flagship routes: the
    action sampled from logits in the launch, 8 and 16 lanes) at B = 8192,
    4096, 1001 and 1 and the global env offsets 0 and 3B, 12 steps each
    under logits scaled x0.1, x3, x30 and exact ties: actions, state,
    reward, done and lines bit-equal to ``sample_actions_plain`` +
    ``step_plain``, log-probs within ``LOG_PROB_ULPS`` of the plain one and
    bit-equal to ``ppo_sample``'s (``flagship_sample_diff``; in phase 31 at
    every geometry, B = 4096, 1001 and 1, 8 steps).
22. ``flagship_observe_board`` against its plain version and the turbo
    ``observe_board``, and ``render_rgb84`` against
    ``preprocess_rgb84(render_rgb(state))``, on every state of phase 21;
    ``observe_dict`` (and its strips-only mode) and
    ``flagship_observe_board`` at B = 1 and at batches that give each of
    their launches' envs-a-block choices, half the envs scrambled
    (``observation_choices_diff``). Then the ``--impl flagship --obs
    board`` path: the committed PPO policy's 512 greedy games on the
    flagship engine, with exact launch counts, must give phase 5's
    statistics.
23. A small fp32 pixel DQN (32 envs, K = 4, buffer 32 x 16, batch 16,
    learning from step 8, a target sync every 16, 30 steps) on the card and
    on the CPU from the same weights: replay contents, env states and the
    window bit-equal, each parameter leaf's change within
    ``SMALL_PIX_PARAM_TOL`` of its norm.
24. The pixel DQN path: ``examples/train_cnn.py --obs rgb84 --frame-stack
    4`` at the committed run's shape (512 envs, buffer 262,144 frames of
    84x84, batch 512, lr 1e-4, sync every 500, ``AtariQNetwork`` with a
    bf16 trunk) and schedule (epsilon over 6000 steps, learning from step
    500) for 2000 steps from the JAX run's initial weights
    (``results/atari_q_k4_init_seed1.npz``): exact launch counts, finite
    metrics, weights that move, the start check (steps 1-500 within
    ``PIX_START_TOL`` of ``results/dqn_rgb84.jsonl``) and the learning gate
    (steps 1751-2000 at least ``PIX_GATE`` times steps 1-500) in 250-step
    chunks beside the JAX curve, the step split with CUDA events, the
    card's busy share, a 512-episode greedy ``evaluate_q_checkpoint`` of
    the trained and the untrained net, and every kernel of the path against
    its plain version on the trained state at its shapes (B = 512, the full
    wrapped buffer).
25. The flagship kernels' and ``render_rgb84``'s times beside their bounds
    and the launch floor at B = 512, 2048 and 65536, each ``flagship_step``
    build's, and ``render_rgb84``'s bound under the earlier 2-D count
    too (the plain versions at most at B = 4096, scaled), and the reused
    kernels at the 7056-byte frame (B = 512 and 65536; ``replay_add``
    beside the obs field's ``copy_``, its library time, and the earlier
    yardstick, ``index_copy_`` of every field).

26. The Gymnasium surface's kernels against their plain versions, bit for
    bit: ``grouped_flagship`` (ids, boards, features under all 16 flag
    sets), ``feature_vector`` (the wrapper's build at every state, each
    build forced, words and bytes, every 25th and on the stacks, and an
    unpadded crop whose storage ends inside a word), ``observe_dict`` and
    ``compose_rgb`` (grouped rgb, ``group`` 40, with ids outside the
    palette too; each run length forced every 25th state and on the
    stacks) on 300-step flagship trajectories
    (B = 4096, 1001, 1) and hand-built stacks with a full holder;
    ``render_rgb84`` still bit-equal; the flagship grouped engine at 4096
    envs equal to the turbo grouped engine through ``turbo.from_flagship``
    for 100 steps (masks, features, rewards, done, lines, env fields).
27. ``Tetris(device="cuda")`` against ``Tetris(device="cpu")`` over 20
    seeded episodes of random actions (ids -1, 8 and 11 included): the Dict
    obs, reward, termination, ``lines_cleared``, ``render("rgb_array")`` and
    the ansi render equal at every step; ``GroupedActionsObservations`` over
    ``Tetris`` in the features, boards, rgb and host modes (and features
    without termination), legal and illegal actions, and
    ``RgbObservation`` and ``FeatureVectorObservation``, card against CPU;
    exact launch counts a step, ``feature_vector``'s and ``compose_rgb``'s
    by batch (B = 1 and the 40 candidates), each run a path of the kernels
    line.
28. The batched flagship grouped engine at 4096 envs, 32 steps of random
    legal placements in features and boards mode: placements/s, exact
    launch counts, the step's parts with CUDA events; ``grouped_flagship``
    in its three modes bit-equal to its plain version on each run's last
    state.
29. ``TetrisVectorEnv`` at 8192 envs x 64 steps, ``impl="turbo"`` and
    ``"flagship"``, numpy in and out: env-steps/s, exact launch counts, the
    first 16 steps (mostly hard drops, so episodes end in them) equal to a
    CPU run, ``final_obs`` included.
30. The new kernels' device ms at B = 1, 4096 and 65536 (``grouped_flagship``
    in its three modes, held to its plain version on the timed state first,
    its operations counted from the launch's own lines) beside their bounds
    and plain versions, ``feature_vector`` and ``compose_rgb`` at the
    grouped wrapper's 40 candidates too, ``compose_rgb`` beside its
    yardstick, and one shell step's host ms at B = 1.

31. The engine kernels at other geometries (``wide_geometries``: 30x20 with
    and without gravity, 61x12 with a queue of 3, 28x14 with bit 31 of word
    0 in play, 8x12 with a uniform queue of 2, and 6x6 pieces at widths 10
    and 30), each built for its geometry in phase 2: ``turbo_init``,
    ``turbo_step`` (every build, as in phase 3), ``observe_board``,
    ``heights``, ``flagship_init``, ``flagship_step`` and
    ``flagship_observe_board`` bit-equal to their plain versions on 300-step
    trajectories at B = 4096, 1001 and 1, on hand-built stacks with up to
    six full rows, and on drops that clear rows whose gaps straddle the word
    boundary (columns 0, 12, 14, 26; one and two rows) at 30x20; the
    sampling builds of ``turbo_step`` as in phase 3 and every build of
    ``flagship_step`` (its sampling builds too) as in phase 21 at every
    geometry; ``turbo_init`` in both key layouts as in phase 3;
    ``flagship_observe_board`` at every envs-a-block choice as in phase 22.
32. The turbo engine equal to the flagship engine at 30x20 and 61x12, 120
    steps at 4096 envs.
33. The slice's path: ``TetrisVectorEnv`` at width 30, height 20 as in
    phase 29 (8192 envs x 64 steps, both engines, the first 16 steps equal
    to a CPU run, exact launch counts, env-steps/s).
34. The engine kernels' device ms at B = 4096 and 65536 at 30x20 and 61x12
    (``turbo_step`` also with the observation), and ``turbo_step`` (both
    ways), ``observe_board``, ``flagship_step`` and ``heights`` at the
    default geometry at 65536, and ``TetrisVectorEnv``'s kernels at its B =
    8192 at the default geometry and 30x20 (the ``vector_env`` paths'
    times in the kernels line), beside their bounds and plain versions, and
    each ``flagship_step`` build's.

35. The six surface kernels at every geometry of phase 31 and at a holder
    longer than the queue (queue 1, holder 2), each built for it in phase
    2: ``observe_dict`` (and its strips), ``compose_rgb``, ``render_rgb84``
    (wherever JAX's resize takes the composite: at all of them) and
    ``feature_vector`` (both builds under all 16 flag sets on the first
    state) bit-equal to their plain versions on 200-step
    flagship trajectories at B = 1001 and 1, ``grouped_flagship`` (ids,
    boards, features) and ``grouped_placements`` (features, boards) on every
    25th state and on hand-built stacks with up to six full rows; every
    build of ``flagship_step`` against the plain step at every step of the
    trajectories and on the stacks; ``observe_dict`` at every envs-a-block
    choice as in phase 22.
36. The turbo grouped engine equal to the flagship grouped engine on the
    card at 30x14 without gravity, 4096 envs, 50 masked-random steps
    (features, masks, rewards, dones, lines, env fields); ``grouped_flagship``
    bit-equal to its plain version on the last state.
37. The slice's path at 30x20: ``Tetris(width=30, height=20)`` on the card
    against the CPU as in phase 27 (20 episodes, the grouped wrapper in
    every mode), ``RgbObservation`` and ``FeatureVectorObservation`` card
    against CPU, exact launch counts, and a shell step's host ms.
38. The flagship and the turbo grouped engine at 30x20, 4096 envs, features
    mode: step ms, placements/s, exact launch counts; ``grouped_flagship``
    bit-equal to its plain version on the flagship run's last state.
39. The six surface kernels' device ms at 30x20 and 61x12, B = 4096 and
    65536 (the board modes at 4096; ``grouped_flagship``'s ids mode at both),
    beside their bounds and plain versions, ``grouped_flagship`` held to its
    plain version on each timed state first; ``feature_vector`` and
    ``compose_rgb`` at 30x20's B = 1 and 120 (the observation wrappers' own
    batches there).

40. ``grayscale_u8_exact`` bit-equal to its plain version over all 2**24
    RGB triples and on a random ``[512, 84, 84, 3]`` batch; the triples
    where it differs from numpy's float64 formula, counted for both (the
    JAX package documents 164), must agree.
41. The compat engine's kernels (``fn_reset``, ``fn_step``, ``fn_observe``)
    bit-equal to their plain versions in every field, the observation,
    reward, terminated and lines, at five configurations
    (``fn_geometries``: the default, no gravity, a uniform queue of 5, width
    30, 8x12 with padding 2), each built for it in phase 2: 300-step
    random-action trajectories (actions 0-7) at B = 4096, 1001 and 1, ended
    games starting afresh every 25 steps, the observation of every state;
    then hand-built stacks (1-4 full rows, a non-empty row 0, queues at their
    refill boundary, games over), each taking every action 0-7, where a line
    clear's copy of row 0, a refill and a frozen game must each show.
    First, ``fn_reset`` bit-equal to ``reset_plain`` in every field and
    the observation at B = 1, 2, 3, 17, 4096 and 65536
    (:func:`fn_reset_diff`).
42. The slice's path: ``examples/play_random_functional.py``'s game from
    ``prng_key(42)`` on the card equal to the plain versions on the CPU
    (steps, score, last observation; steps/s; exact launch counts), then
    ``batched_reset`` and ``rollout`` at B = 65536, T = 64: env-steps/s,
    exact launch counts (1 ``fn_reset``, 1 ``fn_step`` a step, 0
    ``fn_observe``), the first 1024 envs' trajectories equal to a CPU run.
43. Device ms of ``fn_step`` (live and frozen states), ``fn_observe`` and
    ``fn_reset`` at B = 1, 8192 and 65536, and of ``grayscale_u8_exact``
    at 2**24 pixels and ``[512, 84, 84, 3]``, beside their bounds and
    plain versions.

44. A small fp32 PPO train step on the pixel chain (32 envs, 8 steps, K =
    4, 2 epochs of 2 minibatches, ``AtariActorCritic`` from
    ``results/atari_actor_critic_k4_init_seed1.npz``) on the card under
    cuDNN's deterministic algorithms against the same step on the CPU: the
    rollout (windows, actions, rewards, dones), the env states and the
    window bit-equal, through ``flagship_step``'s sampling build,
    ``render_rgb84`` and ``framestack_push`` on the card (exact launch
    counts: no ``ppo_sample``) and their plain versions on the CPU; the
    card's actions equal and its log-probs
    within ``LOG_PROB_ULPS`` of ``sample_actions_plain`` on its own
    logits; values and log-probs within ``SMALL_PIX_PPO_OUT_TOL`` of their
    scale card against CPU; each parameter leaf's change within
    ``SMALL_PIX_PARAM_TOL`` of its norm.
45. The pixel PPO path: ``examples/train_ppo.py --obs rgb84 --frame-stack
    4`` at the JAX example's defaults (2048 envs x 128 steps, 6 epochs of 8
    minibatches, bf16 trunk) for 3 train steps in one chunk from the JAX
    run's initial weights: exact launch counts (a train step 128 each of
    ``flagship_step``, all of them its sampling build, ``render_rgb84`` and
    ``framestack_push``, 1 ``gae``, no ``ppo_sample`` and no
    ``turbo_step``), finite metrics,
    weights that move, the train step split into rollout, GAE and update
    with CUDA events, env-steps/s, the policy forward's device ms, peak
    memory, then 512 greedy games (K = 4, seed 0) of the initial and the
    trained weights with exact launch counts (lines/episode reported, not
    gated).
46. The pixel PPO path's kernels at its batch (B = 2048; T = 128 for
    ``gae``, on one more rollout) on the trained state, bit-equal to their
    plain versions (every ``flagship_step`` build, with the sample at
    offsets 0 and 3B and without), and their device ms beside their bounds,
    the launch floor and plain versions, each ``flagship_step`` build's too,
    and the sampling step beside ``ppo_sample`` then ``flagship_step``.
47. The board PPO trainer from scratch: ``examples/train_ppo.py`` at the
    settings of ``results/ppo.jsonl`` (2048 envs x 128 steps, seed 1) for
    10 iterations from that JAX run's initial weights
    (``results/ppo_init_seed1.npz``): iteration 1's reward per step within
    ``CURVE_START_TOL`` of the record's, iteration 10's at least
    ``CURVE_GATE`` times iteration 1's.
48. ``ppo_sample``, ``turbo_step``'s and ``flagship_step``'s sampling
    builds (each lanes build) and
    ``dqn_act`` at B = 2048 and 8192 and the global counter offsets 0, B
    and 3B: bit-equal to their plain versions at that offset and to the
    slice ``[offset, offset + B)`` of one launch over 4B envs; their
    device ms at offsets 0 and 3B.
49.-51. The multi-device paths (:func:`run_sharded`): ranks of the
    launcher's process groups, started as ``chip_smoke.py --rank-worker``
    processes, at W = 1 over NCCL and W = 2 over gloo on CUDA tensors
    (both ranks on this card), against unsharded runs in this process.
    ``launch.run`` at the JAX launcher's defaults (65536 x 256 x 4,
    flagship) and a compat rollout (65536 x 64): checksums, Σreward and
    Σdone equal everywhere; env-steps/s of each.  The main path's PPO
    (phase 9's shape, 3 train steps, cuDNN's deterministic algorithms):
    the first step's env checksum equal everywhere and its loss terms
    within ``SHARD_LOSS_TOL``, each world's ranks equal in every step and
    in their parameters, exact launches; the later steps' checksums and
    the envs that differ from the unsharded run's reported; the step split
    into rollout, update and collectives by CUDA events.  ``launch.main
    --train dqn`` (65536 envs) and ``--train ppo`` (flagship, 8192 envs),
    3 iterations each: env and replay checksums equal at W = 1 and 2 and
    on every rank, each world's ranks holding equal parameters.

52. ``utils/video.py`` on the card: the random policy's episodes (seeds
    0-3, the default board and 30x20) bit-equal to the same calls on the
    CPU, each frame exactly one ``flagship_step``, ``flagship_observe_board``,
    ``observe_dict`` and ``compose_rgb`` and an episode one
    ``flagship_init``; a greedy episode of the committed policy (fp32,
    cuDNN's deterministic algorithms) equal to the CPU's, its length and
    lines, its GIF under ``build/``; the host ms a frame.
53. ``examples/evaluate_checkpoint.py --net actor-critic`` on the committed
    policy (512 episodes, seed 0) prints exactly what ``rl.evaluate.main``
    gives for the same arguments, with phase 5's launches, beside phase 5's
    lines/episode.
54. Whole-state checkpoints at the main path's width: PPO at 8192 x 128
    from the committed weights (cuDNN's deterministic algorithms), a train
    step, ``save`` of the whole ``TrainState``, a second step; ``restore``
    into a fresh template, one step: bit-equal to the second (env checksum
    and fields, every parameter, Adam's moments, metrics), with a train
    step's launches.  A CNN DQN state (K = 4) with its full 262,144-entry
    buffer round-trips, and a step from each copy is equal.  Seconds and
    bytes of each save and restore.
55. ``train_ppo --n-envs 2048 --iterations 2 --video-every 1 --wandb``
    (wandb hidden: no network here) writes two GIFs, warns once, and its
    JSONL without ``sps`` equals a run without the flags; one main-path
    train step inside ``utils.profiling.trace`` (128 ``turbo_step``
    launches and one ``gae`` by the wrappers' counts) gives a trace that
    names both kernels.
56. The port's wheel: the tree's sources copied under
    ``build/wheel_smoke/``, ``pip wheel --no-deps --no-build-isolation
    --no-index`` there; the wheel holds every file of
    ``tetris_gymnasium_torch/csrc/``; installed with ``pip install
    --target``, ``tools/wheel_smoke_torch.py`` runs in a subprocess from a
    directory outside the package with its per-user cache under
    ``build/wheel_smoke/``: the installed package builds ``fn_step`` at
    10x20 from its own ``csrc/`` into that cache (not into the install),
    launches it and holds 32 steps of 4096 envs to ``step_plain``.

Then the kernels line (25 kernels; ``turbo_step``'s time is its launch
with the observation, as the paths take it, with its sampling builds' and
``gae``'s builds' times at B = 8192 beside it; each with the launch counts of
the first path that runs it: the pixel DQN, else the flagship board
evaluation, else the K = 4 DQN, else the K = 1 DQN, else the grouped DQN,
else PPO, else pixel PPO, else the grouped engine, else
the shell, else each mode of its grouped wrapper, else each observation
wrapper, else the compat rollout; times at the shape of that path, a
wrapper path's ``feature_vector`` and ``compose_rgb`` by batch in its
``on_paths`` entry (B = 1 and the 40 or 120 candidates, phases 30 and 39);
``compose_rgb``'s library time the yardstick ``palette_ext[id_image]``
given the composed id image;
``heights``, ``fn_observe``, ``grayscale_u8_exact`` and ``ppo_sample``,
which no path calls (every PPO route samples in its step's launch), with
0 launches and their times at 30x20 and B = 4096, at B = 65536, over 2**24
pixels and at pixel PPO's B = 2048; ``flagship_step`` with its sampling
builds' launches and times on pixel PPO's path; ``turbo_init`` with the
grouped DQN's launches and time in its ``on_paths``; ``dqn_act`` with its greedy launch's time
and ``torch.argmax``'s as its library time; each with its builds, one a
geometry, and the six surface kernels with their phase-39 times; every
kernel with a rank's launches on the sharded paths at W = 2 and on the
utilities' paths (phases 52-54), and
``ppo_sample``, ``turbo_step`` and ``flagship_step`` (their sampling
builds) and ``dqn_act`` with their times at global counter offsets 0 and
3B; ``dqn_act`` with its ``call_ms`` with keys, ``fn_reset`` with its
times at each batch of phase 43 (``ms_by_batch``: B = 1 is the example's
game)) and, last, the device line.
Any failed check raises, so the exit code is not 0.  The script imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PARAMS = os.path.join(REPO, "results", "ppo_lines_params.npz")
EVAL_EPISODES, EVAL_MAX_STEPS, EVAL_SEED = 512, 2000, 0
JAX_LINES = 10.41  # JAX package, 512 greedy episodes (README.md)
MIN_LINES = 9.5
# The training path: examples/train_ppo.py warm-started at the phase-F
# settings of docs/scale/rl.md (lr 4e-5, ent-coef 0.004), default rewards.
TRAIN_ENVS, TRAIN_T, TRAIN_STEPS = 8192, 128, 3
TRAIN_ARGV = [
    "--n-envs", str(TRAIN_ENVS), "--rollout-len", str(TRAIN_T), "--update-epochs", "6",
    "--n-minibatches", "8", "--iterations", str(TRAIN_STEPS), "--chunk", str(TRAIN_STEPS),
    "--lr", "4e-5", "--ent-coef", "0.004", "--seed", "1", "--init-params", PARAMS,
]
# Phases 8, 14 and 18 run a small fp32 training on the card (cuDNN's
# deterministic algorithms) and on the CPU from the same weights.  Each
# parameter leaf's change agrees within this share of its norm: float32
# sums in another order, magnified by Adam's division by sqrt(v) + 1e-8
# where a gradient is near zero.  Phase 18's convolution weights moved
# 1.6e-6 of their norm between card and CPU, and as much between two card
# runs with cuDNN's default algorithms (an H100 80GB HBM3 at 700 W); the
# largest single difference, reported beside it, was 2.9e-4 of the largest
# single change on one card and 1.9e-3 on another.
SMALL_TRAIN_PARAM_TOL = 1e-3
# ppo_sample's log-prob against the plain version: logf and expf are within
# 1 and 2 ulps of exact (CUDA's documented error bounds), so
# a sum of exps is within 2 ulps (2**-22 relative) and its log within
# 2**-22 absolute plus an ulp of the result; both sides call the same
# functions, so bit-equality is expected and this bound is what is allowed.
LOG_PROB_ULPS = 2
# Phase 7 holds gae's builds at these rollout lengths and batches (ragged
# ones and the main path's), with p_done 0, 1/200 and 1.
GAE_CHECK_T = (1, 7, 128, 129, 512)
GAE_CHECK_B = (1, 16, 1001, 8192, 65536)
# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM,
# 67 TFLOP/s float32 outside the tensor cores, counting an FMA as two, so
# 33.5e12 32-bit lane operations a second.
OPS_PER_S = 33.5e12
SAMPLE_OPS_PER_ELEMENT = 100  # threefry 75, uniform 6, gumbel 4, argmax 9, softmax 6
GAE_OPS_PER_ELEMENT = 8
# grouped_act: per candidate threefry 75, uniform 6, gumbel 4, mask test, two
# selects and two argmax steps 10; per env the exploration draw (threefry 75,
# uniform 6) and the final select
ACT_OPS_PER_CANDIDATE = 95
ACT_OPS_PER_ENV = 82
SAMPLE_INDEX_OPS = 160  # replay_sample: two threefry blocks and the modular index per sample

# The grouped DQN slice.  Phase 11 steps random placements at these lengths.
GROUPED_CHECK_STEPS = 40
# Phase 14: the 6x8 micro-gate configuration of tests/test_learning.py:113-116
# on the default 10x20 board, run past learning_starts and one target sync
# (step 64).
SMALL_GROUPED_CFG = dict(buffer_size=4096, batch_size=128, exploration_steps=250,
                         learning_starts=64, target_update_every=64)
SMALL_GROUPED_STEPS = 70
SMALL_GROUPED_PARAM_TOL = SMALL_TRAIN_PARAM_TOL
# Phase 15: examples/train_lin_grouped.py at the committed run's shape
# (results/grouped_dqn.jsonl: 1024 envs, QMLP, default GroupedDQNConfig:
# buffer 131,072, batch 256), with the schedule that passed the learning gate
# in the JAX package on the CPU (PERF.md, grouped findings), from the JAX run's own
# initial weights (tools/export_grouped_init_params.py --seed 1).
GROUPED_ENVS, GROUPED_STEPS, GROUPED_LEARNING_STARTS = 1024, 2000, 250
GROUPED_INIT = os.path.join(REPO, "results", "grouped_qmlp_init_seed1.npz")
GROUPED_ARGV = [
    "--n-envs", str(GROUPED_ENVS), "--steps", str(GROUPED_STEPS), "--chunk", "50",
    "--exploration-steps", "1500", "--learning-starts", str(GROUPED_LEARNING_STARTS), "--seed", "1",
    "--init-params", GROUPED_INIT,
]
GROUPED_EVAL_EPISODES, GROUPED_EVAL_MAX_STEPS = 512, 512
PROFILED_STEPS = 20  # learning steps traced by torch.profiler after the run
GROUPED_TIME_B = (512, 1024, 4096, 65536)

# The CNN DQN slice.  Phase 19: examples/train_cnn.py at the committed runs'
# shape (results/dqn.jsonl and results/dqn_k4.jsonl: 1024 envs, default
# DQNConfig: buffer 262,144, batch 512, lr 1e-4, sync every 500) and schedule,
# cut to 2000 of 30,000 steps, from the JAX runs' initial weights
# (tools/export_grouped_init_params.py --net q_cnn --seed 1 [--frame-stack 4]).
# The committed runs' records fix their schedule: epsilon 0.9753 at step 250
# and 0.8021 at step 2000 is an anneal over 10,000 steps, and a loss of 0
# through step 1000 that is non-zero from step 1250 is learning from step
# 1000 (the script's defaults today are 6000 and 500).
DQN_ENVS, DQN_STEPS, DQN_CHUNK, DQN_BATCH = 1024, 2000, 250, 512
DQN_EXPLORATION, DQN_LEARNING_STARTS = 10_000, 1000
DQN_INIT = {1: os.path.join(REPO, "results", "qcnn_init_seed1.npz"),
            4: os.path.join(REPO, "results", "qcnn_k4_init_seed1.npz")}
DQN_JAX_CURVE = {1: os.path.join(REPO, "results", "dqn.jsonl"),
                 4: os.path.join(REPO, "results", "dqn_k4.jsonl")}
# reward per env step over steps 1751-2000 against steps 1-500; the committed
# JAX curves give 1.82x for both K
DQN_GATE = 1.4
# Phase 18.
SMALL_DQN_CFG = dict(buffer_size=64 * 16, batch_size=32, learning_starts=8, target_update_every=16,
                     exploration_steps=6000, frame_stack=4)
SMALL_DQN_STEPS = 40
SMALL_DQN_PARAM_TOL = SMALL_TRAIN_PARAM_TOL
# dqn_act: three threefry blocks (~75 each), the argmax over 8 (~16) and the select
DQN_ACT_OPS_PER_ENV = 250
DQN_ARGMAX_OPS_PER_ENV = 16  # its greedy launch: the argmax alone
# replay_sample_stacked: per anchor and frame, the lookback's index and flag test
STACK_OPS_PER_FRAME = 10
DQN_TIME_B = (512, 1024, 65536)

# The pixel CNN DQN slice.  Phases 21-22 step the flagship engine along
# random trajectories with these action weights (left, right, down, cw,
# ccw, hard drop, swap, no-op), biased towards hard drops and swaps.
PIX_ENVS = 512
FLAGSHIP_STEPS = 300
FLAGSHIP_ACTION_P = (0.1, 0.1, 0.08, 0.1, 0.07, 0.3, 0.15, 0.1)
# Phase 23: a small fp32 pixel DQN on the card and on the CPU, held as
# phases 8, 14 and 18 are, within 1e-2 of each leaf's norm: after its 22
# updates the third convolution's weights differ by 1.3e-3 to 1.5e-3 of
# their norm between card and CPU, and as much between two card runs with
# cuDNN's default algorithms (an H100 80GB HBM3 at 700 W).
SMALL_PIX_ENVS, SMALL_PIX_STEPS = 32, 30
SMALL_PIX_CFG = dict(buffer_size=32 * 16, batch_size=16, learning_starts=8, target_update_every=16,
                     exploration_steps=100, frame_stack=4)
SMALL_PIX_PARAM_TOL = 1e-2
# Phase 24: examples/train_cnn.py --obs rgb84 --frame-stack 4 at the shape
# of results/dqn_rgb84.jsonl (512 envs, default DQNConfig: buffer 262,144,
# batch 512, lr 1e-4, sync every 500; AtariQNetwork with a bf16 trunk) and
# its schedule (the script's defaults: epsilon over 6000 steps, learning
# from step 500; its records give epsilon 0.9919 at step 50 and a loss of 0
# through step 500), cut to 2000 of 12,000 steps, from the JAX run's
# initial weights (tools/export_grouped_init_params.py --net atari_q
# --frame-stack 4 --seed 1).
PIX_STEPS, PIX_CHUNK, PIX_BATCH = 2000, 50, 512
PIX_EXPLORATION, PIX_LEARNING_STARTS = 6000, 500
PIX_INIT = os.path.join(REPO, "results", "atari_q_k4_init_seed1.npz")
PIX_JAX_CURVE = os.path.join(REPO, "results", "dqn_rgb84.jsonl")
# reward per env step over steps 1751-2000 against steps 1-500 (the JAX
# curve gives 2.43x), and steps 1-500 within 0.01 of the JAX curve's
PIX_GATE, PIX_START_TOL = 1.8, 0.01
PIX_TIME_B = (512, 65536)
PIX_FLAGSHIP_TIME_B = (512, 2048, 65536)  # the flagship kernels' builds and render_rgb84 (phase 25)
PIX_PLAIN_MAX_B = 4096  # the plain chain's float64 temporaries at larger B pass 10 GB
# 32-bit operations the kernels do, by their own count: flagship_step packs
# 432 cells (3 each), builds up to four 21-window hit maps (8 each) and on a
# lock compacts 20 rows (20 each); flagship_init shuffles 7 pieces (~100)
# and writes 432 cells; flagship_observe_board 200 cells (6 each);
# render_rgb84 JAX's two passes (csrc/render_rgb84.cu): per output pixel and
# channel the vertical pass's 2 multiply-adds (cv2's rounding constant the
# first one's addend), the shift and the clip (its upper half: the sum is
# never negative), and the gray's multiply, 2 multiply-adds and shift; per
# source row, output column and channel the horizontal pass's multiply and
# multiply-add (render_ops).  The earlier 2-D form counted 47 a pixel (4 tap
# weights, 12 multiply-adds, the rounds, both clips and the gray), kept as
# RENDER_OPS_PER_PIXEL_2D beside the bound.
FLAGSHIP_STEP_OPS_PER_ENV = 3 * 432 + 4 * 21 * 8 + 20 * 20
FLAGSHIP_INIT_OPS_PER_ENV = 100 + 432
FLAGSHIP_OBS_OPS_PER_ENV = 6 * 200
RENDER_OPS_PER_PIXEL = 3 * (2 + 2) + 4
RENDER_OPS_PER_ROW_PIXEL = 3 * 2
RENDER_OPS_PER_PIXEL_2D = 4 + 2 * 12 + 3 * 4 + 7


def render_ops(padded_height: int) -> int:
    """32-bit operations of one env's ``render_rgb84`` frame: 124,992 at
    10x20 (17.7 a pixel)."""
    return 84 * 84 * RENDER_OPS_PER_PIXEL + padded_height * 84 * RENDER_OPS_PER_ROW_PIXEL


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Largest |kernel - plain version| seen, by kernel.
MAX_ERR = {"turbo_step": 0.0, "turbo_init": 0.0, "observe_board": 0.0, "gae": 0.0,
           "ppo_sample": 0.0, "grouped_placements": 0.0, "grouped_act": 0.0, "replay_add": 0.0,
           "replay_sample": 0.0, "replay_sample_stacked": 0.0, "framestack_push": 0.0,
           "dqn_act": 0.0, "flagship_step": 0.0, "flagship_init": 0.0,
           "flagship_observe_board": 0.0, "render_rgb84": 0.0, "grouped_flagship": 0.0,
           "feature_vector": 0.0, "observe_dict": 0.0, "compose_rgb": 0.0, "heights": 0.0,
           "fn_reset": 0.0, "fn_step": 0.0, "fn_observe": 0.0, "grayscale_u8_exact": 0.0}


def bits(t):
    """A tensor's bits as int64 (floats by their bit patterns)."""
    if t.dtype in (torch.uint32, torch.float32):
        return t.view(torch.int32).to(torch.int64)
    return t.to(torch.int64)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, so that a card run of a parity phase
    repeats bit for bit: its default weight gradients sum in an order that
    varies from run to run, which Adam magnifies where a gradient is near zero."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


@contextlib.contextmanager
def fp32_math():
    """Convolutions and matmuls in full float32, restored after: PyTorch's
    default lets cuDNN run float32 convolutions in TF32, which moved phase
    44's values by 1.1e-3 of their scale against the CPU where a caller had
    not turned it off as main() does."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def param_change_diff(what, start, card, cpu, tol) -> tuple:
    """Each leaf's change from ``start`` on the card against the CPU's:
    raises unless ``|d_card - d_cpu| <= tol |d_cpu|`` (L2 norms) and the leaf
    moved.  Returns the largest norm ratio and the largest single difference
    over the largest single change, which is reported, not gated: Adam moves
    a weight whose gradient is near zero by up to a learning rate, whatever
    the sign of that gradient's last bits."""
    norm_worst = elem_worst = 0.0
    for k, p0 in start.items():
        d_card, d_cpu = card[k] - p0, cpu[k] - p0
        rel = float(np.linalg.norm(d_card - d_cpu)) / max(float(np.linalg.norm(d_cpu)), 1e-30)
        norm_worst = max(norm_worst, rel)
        elem_worst = max(elem_worst, float(np.abs(d_card - d_cpu).max())
                         / max(float(np.abs(d_cpu).max()), 1e-30))
        if not np.abs(d_cpu).max() > 0 or rel > tol:
            raise AssertionError(f"{what}: {k} changed by {rel} of its change's norm "
                                 "between card and CPU")
    return norm_worst, elem_worst


def values(t):
    if t.dtype == torch.uint32:
        return (t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).to(torch.float64)
    return t.to(torch.float64)


def diff(kernel, a, b, what):
    """Records max |a - b| for ``kernel``; raises unless a and b are bit-equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if a.numel():
        err = float((values(a) - values(b)).abs().max())
        MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    if not torch.equal(bits(a), bits(b)):
        bad = (bits(a) != bits(b)).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: kernel and plain version differ at {bad}")


def call_ms(fn, n):
    """Time per call as launched from Python (host overhead included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n, replays=7):
    """Device time per call: ``n`` calls captured in one CUDA graph; the
    median over ``replays`` timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(replays + 1)]
    marks[0].record()
    for m in marks[1:]:
        graph.replay()
        m.record()
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) / n for a, b in zip(marks, marks[1:]))
    del graph
    return per[len(per) // 2]


L2_FLUSH_BYTES = 128 * 2**20  # over twice the H100's 50 MB L2


def cold_device_ms(fn, n, dev):
    """Device time per call of ``fn`` on inputs read from HBM: a read of
    ``L2_FLUSH_BYTES`` before each call evicts what the last call left in
    the L2, and the time of that read alone is taken off."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, device=dev)
    sink = torch.empty((), device=dev)

    def flush():
        torch.sum(buf, dim=0, out=sink)

    return device_ms(lambda: (flush(), fn()), n) - device_ms(flush, n)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def timed_pair(kernel_fn, plain_fn, n_kernel, n_plain, io, ops) -> dict:
    """Device ms of a kernel and of its plain version, beside the bound."""
    return {"ms": device_ms(kernel_fn, n_kernel), "plain_ms": device_ms(plain_fn, n_plain),
            "call_ms": call_ms(kernel_fn, n_kernel), **_bound(io, ops)}


STEP_PARTS = ("act", "env", "add", "update", "sync")  # the DQN steps' marks after "start"


def split_ms(steps) -> dict:
    """Mean ms between the marks of a DQN step, from one dict of CUDA events a step."""
    out = {p: 0.0 for p in STEP_PARTS}
    for e in steps:
        for a, b in zip(("start",) + STEP_PARTS, STEP_PARTS):
            out[b] += e[a].elapsed_time(e[b]) / len(steps)
    out["step"] = sum(out[p] for p in STEP_PARTS)
    return out


def profile_steps(step, ts):
    """``PROFILED_STEPS`` more steps under ``torch.profiler``: ``(ts, the
    card's busy and idle share and its top kernels per step)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            ts, _ = step(ts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels_us = {}  # device activity by name; annotations (Optimizer.step) span kernels, so skip them
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
    for e in device_events:
        kernels_us[e.name] = kernels_us.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(kernels_us.values()) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    return ts, {"steps": PROFILED_STEPS, "wall_ms_per_step_profiled": wall_ms / PROFILED_STEPS,
                "device_busy_ms_per_step": busy_ms / PROFILED_STEPS,
                "device_idle_share": 1 - busy_ms / wall_ms,
                "device_launches_per_step": len(device_events) / PROFILED_STEPS,
                "top_device_us_per_step": {k[:60]: v / PROFILED_STEPS for k, v in top}}


def flat_bytes(tensors):
    """The tensors' bytes end to end (uint8), for one bit-for-bit comparison."""
    return torch.cat([(t.view(torch.int32) if t.dtype == torch.uint32 else t).contiguous()
                      .view(torch.uint8).reshape(-1) for t in tensors])


def step_variants_diff(s, a, cfg, pieces, rw, max_clear, want, what, want_obs=None) -> int:
    """Every build of ``turbo_step`` (each lanes count of
    ``kernels.STEP_LANES``, without and with the observation written in the
    same launch) on ``(s, a)`` against the plain step's ``want = (state,
    reward, done, lines)`` and ``want_obs``, ``observe_board_plain`` of its
    state (computed here unless given), bit for bit; returns the number of
    launches compared."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import turbo

    B = s.piece.shape[0]
    if want_obs is None:
        want_obs = turbo.observe_board_plain(want[0], cfg, pieces)
    outs = [getattr(want[0], k) for k in turbo.FIELDS] + list(want[1:])
    want_all = {False: flat_bytes(outs), True: flat_bytes(outs + [want_obs])}
    builds = [(lanes, with_obs) for lanes in kernels.STEP_LANES for with_obs in (False, True)]
    runs, differs = [], []
    for lanes, with_obs in builds:
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8,
                          device=s.rows.device) if with_obs else None
        got = kernels.turbo_step(s, a, cfg, pieces, rw, max_clear, obs=obs, lanes=lanes)
        parts = [getattr(got[0], k) for k in turbo.FIELDS] + list(got[1:])
        got_all = flat_bytes(parts + ([obs] if with_obs else []))
        differs.append((got_all != want_all[with_obs]).any())
        runs.append((got, obs))
    if not bool(torch.stack(differs).any()):  # one wait for every build; bit-equal
        return len(builds)
    for (lanes, with_obs), (got, obs) in zip(builds, runs):  # diff raises at the first difference
        tag = f"{what} (lanes {lanes}{', obs' if with_obs else ''})"
        for k in turbo.FIELDS:
            diff("turbo_step", getattr(got[0], k), getattr(want[0], k), f"{tag} {k}")
        for j, out in ((1, "reward"), (2, "done"), (3, "lines")):
            diff("turbo_step", got[j], want[j], f"{tag} {out}")
        if with_obs:
            diff("turbo_step", obs, want_obs, f"{tag} obs")
    raise AssertionError(f"{what}: a build differs from the plain step")


def flagship_builds_diff(parts, cfg, pieces, rw, want, what) -> list:
    """Every build of ``flagship_step`` (each lanes count of
    ``kernels.FLAGSHIP_LANES``) on each ``(state, action)`` of ``parts``,
    their outputs side by side against the plain step's ``want = (state,
    reward, done, lines)`` of the parts side by side, bit for bit; returns
    each part's outputs from the build that ``kernels.flagship_step_lanes``
    takes at its batch."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import engine

    want_all = flat_bytes([getattr(want[0], k) for k in engine.FIELDS] + list(want[1:]))
    runs, differs = {}, []
    for lanes in kernels.FLAGSHIP_LANES:
        outs = [kernels.flagship_step(s, a, cfg, pieces, rw, lanes=lanes) for s, a in parts]
        got = (_cat_flagship([o[0] for o in outs]), *(torch.cat([o[j] for o in outs]) for j in (1, 2, 3)))
        differs.append((flat_bytes([getattr(got[0], k) for k in engine.FIELDS] + list(got[1:]))
                        != want_all).any())
        runs[lanes] = (outs, got)
    if bool(torch.stack(differs).any()):
        for lanes, (_, got) in runs.items():  # diff raises at the first difference
            for k in engine.FIELDS:
                diff("flagship_step", getattr(got[0], k), getattr(want[0], k), f"{what} (lanes {lanes}) {k}")
            for j, out in ((1, "reward"), (2, "done"), (3, "lines")):
                diff("flagship_step", got[j], want[j], f"{what} (lanes {lanes}) {out}")
        raise AssertionError(f"{what}: a flagship_step build differs from the plain step")
    return [runs[kernels.flagship_step_lanes(s.piece.shape[0], cfg.padded_height)][0][i]
            for i, (s, _) in enumerate(parts)]


def sample_variants_diff(s, x, key, cfg, pieces, rw, what) -> tuple:
    """Both sampling builds of ``turbo_step`` (each lanes count of
    ``kernels.STEP_LANES``, with the observation; the action sampled in the
    launch from logits ``x`` and ``key``) on ``s`` against
    ``sample_actions_plain`` + ``step_plain`` + ``observe_board_plain`` and
    against the stand-alone ``ppo_sample`` kernel: actions, state,
    observation, reward, done and lines bit-equal to the plain versions,
    log-probs bit-equal to ``ppo_sample``'s and within ``LOG_PROB_ULPS``
    (and 2**-22) of the plain one.  Returns ``(the plain step's state, the
    launches compared, the largest log-prob error in ulps, whether every
    log-prob was bit-equal to the plain one)``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.rl import ppo

    B = s.piece.shape[0]
    pa, plp = ppo.sample_actions_plain(x, key)
    want = turbo.step_plain(s, pa, cfg, pieces, rw)
    want_obs = turbo.observe_board_plain(want[0], cfg, pieces)
    want_all = flat_bytes([getattr(want[0], k) for k in turbo.FIELDS] + list(want[1:])
                          + [want_obs, pa])
    ka, klp = kernels.sample_actions(x, key)
    ulp = torch.nextafter(plp.abs(), torch.full_like(plp, float("inf"))) - plp.abs()
    tol = 2.0**-22 + LOG_PROB_ULPS * ulp.double()
    runs, differs, errs = [], [], []
    for lanes in kernels.STEP_LANES:
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=s.rows.device)
        got = kernels.turbo_step(s, None, cfg, pieces, rw, obs=obs, lanes=lanes, logits=x,
                                 act_key=key)
        parts = [getattr(got[0], k) for k in turbo.FIELDS] + list(got[1:4]) + [obs, got[4]]
        err = (got[5].double() - plp.double()).abs()
        differs += [(flat_bytes(parts) != want_all).any(), (got[4] != ka).any(),
                    (bits(got[5]) != bits(klp)).any(), (err > tol).any()]
        errs.append(err / ulp.double())
        runs.append((lanes, got, obs, err))
    if bool(torch.stack(differs).any()):  # one wait for every build
        for lanes, got, obs, err in runs:  # diff raises at the first difference
            tag = f"{what} (sample, lanes {lanes})"
            diff("turbo_step", got[4], pa, f"{tag} action")
            diff("ppo_sample", got[4], ka, f"{tag} action against ppo_sample")
            for k in turbo.FIELDS:
                diff("turbo_step", getattr(got[0], k), getattr(want[0], k), f"{tag} {k}")
            for j, out in ((1, "reward"), (2, "done"), (3, "lines")):
                diff("turbo_step", got[j], want[j], f"{tag} {out}")
            diff("turbo_step", obs, want_obs, f"{tag} obs")
            diff("ppo_sample", got[5], klp, f"{tag} log_prob against ppo_sample")
            if bool((err > tol).any()):
                raise AssertionError(f"{tag}: log_prob off the plain one by {float(err.max())}")
        raise AssertionError(f"{what}: a sampling build differs")
    worst = max(float(e.max()) for e in errs)
    MAX_ERR["ppo_sample"] = max(MAX_ERR["ppo_sample"], max(float(r[3].max()) for r in runs))
    return want[0], len(runs), worst, bool(torch.equal(bits(runs[0][1][5]), bits(plp)))


SAMPLE_B = (8192, 4096, 1001, 1)
SAMPLE_STEPS = 16
SAMPLE_KINDS = (0.1, 3.0, 30.0, "ties")  # logits scaled so, or exact ties (integers 0-2)


def check_sample_builds(dev, cfg, pieces, name, seed) -> dict:
    """Both sampling builds of ``turbo_step`` (:func:`sample_variants_diff`)
    at ``SAMPLE_B`` along ``SAMPLE_STEPS`` steps of the plain composition,
    the logits of each step one of ``SAMPLE_KINDS`` in turn, the key drawn
    from ``seed``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import RewardsMapping
    from tetris_gymnasium_torch.ops.threefry import fold_in, prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n = worst = 0
    lp_bit_equal = True
    for B in SAMPLE_B:
        s = kernels.turbo_init(batch_keys(prng_key(seed + B), B, device=dev), cfg, pieces)
        for i in range(SAMPLE_STEPS):
            kind = SAMPLE_KINDS[i % len(SAMPLE_KINDS)]
            if kind == "ties":
                x = torch.randint(0, 3, (B, 8), generator=g, device=dev).float()
            else:
                x = torch.randn((B, 8), generator=g, device=dev) * kind
            key = fold_in(prng_key(seed), B * SAMPLE_STEPS + i)
            s, k, w, eq = sample_variants_diff(s, x, key, cfg, pieces, RewardsMapping(),
                                               f"{name} B={B} step {i} logits {kind}")
            n, worst, lp_bit_equal = n + k, max(worst, w), lp_bit_equal and eq
    return {"geometry": name, "B": list(SAMPLE_B), "steps": SAMPLE_STEPS,
            "sample_builds_compared": n, "log_prob_max_ulps": worst,
            "log_prob_bit_equal_plain": lp_bit_equal}


def flagship_sample_diff(s, x, key, cfg, pieces, rw, what, env_offset=0) -> tuple:
    """Both sampling builds of ``flagship_step`` (each lanes count of
    ``kernels.FLAGSHIP_LANES``; the action sampled in the launch from logits
    ``x`` and ``key``, env ``b`` drawing at global env ``env_offset + b``)
    on ``s`` against ``sample_actions_plain`` + ``step_plain`` and the
    stand-alone ``ppo_sample`` kernel at the same offset: actions, state,
    reward, done and lines bit-equal to the plain versions, log-probs
    bit-equal to ``ppo_sample``'s and within ``LOG_PROB_ULPS`` (and 2**-22)
    of the plain one.  Returns ``(the plain step's state, the launches
    compared, the largest log-prob error in ulps, whether every log-prob was
    bit-equal to the plain one)``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.rl import ppo

    pa, plp = ppo.sample_actions_plain(x, key, env_offset)
    want = engine.step_plain(s, pa, cfg, pieces, rw)
    want_all = flat_bytes([getattr(want[0], k) for k in engine.FIELDS] + list(want[1:]) + [pa])
    ka, klp = kernels.sample_actions(x, key, env_offset=env_offset)
    ulp = torch.nextafter(plp.abs(), torch.full_like(plp, float("inf"))) - plp.abs()
    tol = 2.0**-22 + LOG_PROB_ULPS * ulp.double()
    runs, differs = [], []
    for lanes in kernels.FLAGSHIP_LANES:
        got = kernels.flagship_step(s, None, cfg, pieces, rw, lanes=lanes, logits=x, act_key=key,
                                    env_offset=env_offset)
        err = (got[5].double() - plp.double()).abs()
        differs += [(flat_bytes([getattr(got[0], k) for k in engine.FIELDS] + list(got[1:5]))
                     != want_all).any(), (got[4] != ka).any(), (bits(got[5]) != bits(klp)).any(),
                    (err > tol).any()]
        runs.append((lanes, got, err))
    if bool(torch.stack(differs).any()):  # one wait for every build
        for lanes, got, err in runs:  # diff raises at the first difference
            tag = f"{what} (sample, lanes {lanes}, offset {env_offset})"
            diff("flagship_step", got[4], pa, f"{tag} action")
            diff("ppo_sample", got[4], ka, f"{tag} action against ppo_sample")
            for k in engine.FIELDS:
                diff("flagship_step", getattr(got[0], k), getattr(want[0], k), f"{tag} {k}")
            for j, out in ((1, "reward"), (2, "done"), (3, "lines")):
                diff("flagship_step", got[j], want[j], f"{tag} {out}")
            diff("ppo_sample", got[5], klp, f"{tag} log_prob against ppo_sample")
            if bool((err > tol).any()):
                raise AssertionError(f"{tag}: log_prob off the plain one by {float(err.max())}")
        raise AssertionError(f"{what}: a flagship sampling build differs")
    MAX_ERR["flagship_step"] = max(MAX_ERR["flagship_step"], max(float(r[2].max()) for r in runs))
    worst = max(float((r[2] / ulp.double()).max()) for r in runs)
    return want[0], len(runs), worst, bool(torch.equal(bits(runs[0][1][5]), bits(plp)))


FLAGSHIP_SAMPLE_STEPS = 12


def check_flagship_sample_builds(dev, cfg, pieces, name, seed, batches=SAMPLE_B,
                                 steps=FLAGSHIP_SAMPLE_STEPS) -> dict:
    """Both sampling builds of ``flagship_step`` (:func:`flagship_sample_diff`)
    at ``batches`` and the global env offsets 0 and 3B along ``steps``
    steps of the plain composition, the logits of
    each step one of ``SAMPLE_KINDS`` in turn (hard drops favoured, so that
    games end and reset within the run), the key drawn from ``seed``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import RewardsMapping
    from tetris_gymnasium_torch.ops.threefry import fold_in, prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n = worst = ends = 0
    lp_bit_equal = True
    for B in batches:
        for off in (0, 3 * B):
            s = kernels.flagship_init(batch_keys(prng_key(seed + B + off), B, device=dev), cfg, pieces)
            for i in range(steps):
                kind = SAMPLE_KINDS[i % len(SAMPLE_KINDS)]
                if kind == "ties":
                    x = torch.randint(0, 3, (B, 8), generator=g, device=dev).float()
                else:
                    x = torch.randn((B, 8), generator=g, device=dev) * kind
                x[:, 5] += 3.0
                key = fold_in(prng_key(seed), B * steps + i)
                s2, k, w, eq = flagship_sample_diff(s, x, key, cfg, pieces, RewardsMapping(),
                                                    f"{name} B={B} step {i} logits {kind}", off)
                ends += int((s2.game_over | (s2.steps < s.steps)).sum())
                s = s2
                n, worst, lp_bit_equal = n + k, max(worst, w), lp_bit_equal and eq
    return {"geometry": name, "B": list(batches), "offsets": "0, 3B", "steps": steps,
            "sample_builds_compared": n, "log_prob_max_ulps": worst,
            "log_prob_bit_equal_plain": lp_bit_equal, "episodes_ended_or_reset": ends}


def turbo_init_diff(dev, cfg, P, what, batches=None) -> list:
    """``turbo_init`` against ``turbo.init_plain`` from keys ``[B, 2]`` and
    from the state's ``[2, B]`` layout (``key_rows``, as
    ``turbo.init_from_key`` passes it) in both queue kinds, at B = 1, 33,
    1001 (row segments that straddle 16-byte words), the grouped DQN's 1024,
    at batches that leave a part-full last block of a few envs and of 128,
    and at the vector env's 8192; returns the batches."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    batches = batches or (1, 33, 1001, GROUPED_ENVS, 4 * sms + 3, 128 * sms + 5, VECTOR_B)
    for kind in ("bag", "uniform"):
        c = cfg._replace(queue_kind=kind)
        for B in batches:
            keys = batch_keys(prng_key(B + 3), B, device=dev)
            want = turbo.init_plain(keys, c, P)
            _fields_diff("turbo_init", kernels.turbo_init(keys, c, P), want, turbo.FIELDS,
                         f"{what} {kind} B={B}")
            _fields_diff("turbo_init", kernels.turbo_init(keys.T.contiguous(), c, P, key_rows=True),
                         want, turbo.FIELDS, f"{what} {kind} B={B} [2, B] key")
    return list(batches)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, REPO)
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.rl.evaluate import evaluate_policy, greedy_logits
    from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    builds = kernels.build([(cfg, P) for _, cfg, P in surface_geometries()]
                           + [(EngineConfig(**GROUPED_WIDE), turbo.PIECES)],
                           [(cfg, turbo.PIECES) for _, cfg, _ in fn_geometries()])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [{k: b.get(k) for k in ("name", "defines", "seconds", "cached", "extra_flags")}
                      for b in builds]})
    for b in builds:
        tag = ",".join(f"{k[7:].lower()}={v}" for k, v in b["defines"].items())
        for line in b["ptxas"].splitlines():
            print(f"  [{b['name']}{'@' + tag if tag else ''}] {line.strip()}", flush=True)

    # -- helpers ----------------------------------------------------------------
    def state_diff(kernel, ks, ps, what):
        for k in turbo.FIELDS:
            diff(kernel, getattr(ks, k), getattr(ps, k), f"{what}: {k}")

    # -- 3./4. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    runs = [
        ("autoreset", 4096, 500, EngineConfig(auto_reset=True), RewardsMapping()),
        ("nograv-rewards", 4096, 500, EngineConfig(gravity_enabled=False),
         RewardsMapping(alife=0.5, game_over=-2.0)),
        ("eval-shape", EVAL_EPISODES, 500, EngineConfig(), RewardsMapping()),
        ("uniform", 4096, 200, EngineConfig(auto_reset=True, queue_kind="uniform"),
         RewardsMapping()),
        ("ragged", 1001, 200, EngineConfig(auto_reset=True), RewardsMapping()),
        ("one-env", 1, 200, EngineConfig(auto_reset=True), RewardsMapping()),
    ]
    checked = {"turbo_step": 0, "turbo_init": 0, "observe_board": 0}
    t0 = time.perf_counter()
    summary = []
    for name, B, T, cfg, rw in runs:
        keys = batch_keys(prng_key(0), B, device=dev)
        s = kernels.turbo_init(keys, cfg, turbo.PIECES)
        state_diff("turbo_init", s, turbo.init_plain(keys, cfg), f"{name} init")
        checked["turbo_init"] += 1
        n_done = n_lines = 0
        a = torch.zeros((B,), dtype=torch.int32, device=dev)
        # the plain step and the plain observation of its state, replayed from a CUDA graph
        plain = _graphed(lambda t, x: (lambda o: (o, turbo.observe_board_plain(o[0], cfg)))(
            turbo.step_plain(t, x, cfg, rewards=rw)), s, a)
        obs_s = turbo.observe_board_plain(s, cfg)
        for i in range(T):
            diff("observe_board", kernels.observe_board(s, cfg, turbo.PIECES), obs_s,
                 f"{name} obs @ {i}")
            checked["observe_board"] += 1
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            (ps, pr, pd, pl), pobs = plain(s, a)
            checked["turbo_step"] += step_variants_diff(s, a, cfg, turbo.PIECES, rw, 4,
                                                        (ps, pr, pd, pl), f"{name} step {i}",
                                                        want_obs=pobs)
            n_done += int((pd & ~s.game_over).sum())
            n_lines += int(pl.sum())
            # the graph's outputs are overwritten by its next replay
            s = ps.replace(**{k: getattr(ps, k).clone() for k in turbo.FIELDS})
            obs_s = pobs.clone()
        summary.append({"run": name, "B": B, "steps": T, "episodes_ended": n_done,
                        "lines": n_lines, "seconds": time.perf_counter() - t0})

    # hand-built boards: random stacks with 0..6 full rows and random pieces
    B = 4096
    cfg = EngineConfig()
    pad, height, width = cfg.padding, cfg.height, cfg.width
    play = ((1 << width) - 1) << pad
    s = kernels.turbo_init(batch_keys(prng_key(5), B, device=dev), cfg, turbo.PIECES)
    rows = turbo.u32_to_lanes(s.rows)
    garbage = torch.randint(0, 1 << width, (height - 8, B), generator=g, device=dev) << pad
    keep = torch.rand((height - 8, B), generator=g, device=dev) < 0.6
    rows[8:height] |= torch.where(keep, garbage, 0)
    n_full = torch.randint(0, 7, (B,), generator=g, device=dev)
    full = torch.arange(height, device=dev)[:, None] >= height - n_full
    rows[:height] |= torch.where(full, play, 0)
    s = s.replace(
        rows=turbo.lanes_to_u32(rows).contiguous(),
        piece=torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32),
        rotation=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32),
        x=torch.randint(-3, 18, (B,), generator=g, device=dev, dtype=torch.int32),
        y=torch.randint(0, 5, (B,), generator=g, device=dev, dtype=torch.int32),
    )
    surgery = {}
    for max_clear in (4, height):
        a = torch.where(torch.rand((B,), generator=g, device=dev) < 0.5, 5,
                        torch.randint(0, 8, (B,), generator=g, device=dev)).to(torch.int32)
        ps, pr, pd, pl = turbo.step_plain(s, a, cfg, max_clear=max_clear)
        checked["turbo_step"] += step_variants_diff(s, a, cfg, turbo.PIECES, RewardsMapping(),
                                                    max_clear, (ps, pr, pd, pl),
                                                    f"surgery max_clear={max_clear}")
        kr, kd, kl = pr, pd, pl  # equal to every build's
        diff("observe_board", kernels.observe_board(s, cfg, turbo.PIECES),
             turbo.observe_board_plain(s, cfg), "surgery obs")
        checked["observe_board"] += 1
        surgery[max_clear] = {"lines_max": int(kl.max()), "done": int(kd.sum())}
        if max_clear == 4:
            # a drop onto five full rows overflows the envelope and ends the game
            over = (n_full >= 5) & kd & (kr == 0)
            if not bool(over.any()):
                raise AssertionError("no 5-full-row drop ended its game under max_clear=4")
        elif int(kl.max()) < 5:
            raise AssertionError("max_clear=20 cleared no 5-row stack")
    # the sampling builds: PPO's rollout step, the action sampled in the launch
    sampled = check_sample_builds(dev, EngineConfig(auto_reset=True), turbo.PIECES, "10x20", 3)
    # the init in both key layouts, at the edges of its blocks and the paths' batches
    init_batches = turbo_init_diff(dev, EngineConfig(), turbo.PIECES, "phase 3 init")
    torch.cuda.synchronize()
    emit({"phase": "turbo_step", "bit_equal": True, "max_abs_err": MAX_ERR, "runs": summary,
          "surgery": surgery, "lanes": list(kernels.STEP_LANES), "sample": sampled,
          "comparisons": checked["turbo_step"], "init_comparisons": checked["turbo_init"],
          "init_edge_batches": init_batches, "seconds": time.perf_counter() - t0})
    emit({"phase": "observe_board", "bit_equal": True, "comparisons": checked["observe_board"]})

    # -- 5. the main path --------------------------------------------------------
    # the same small fp32 evaluation on the card and in the plain CPU versions
    small = {}
    for where in ("cuda", "cpu"):
        net32 = load_actor_critic(PARAMS, device=where, dtype=torch.float32)
        small[where] = evaluate_policy(greedy_logits(net32), 8, EngineConfig(), prng_key(0),
                                       max_steps=400, device=where)
    for k in ("lines_mean", "length_mean", "return_mean", "episodes_completed", "truncated"):
        if small["cuda"][k] != small["cpu"][k]:
            raise AssertionError(f"small fp32 evaluation: {k} {small['cuda'][k]} on the card, "
                                 f"{small['cpu'][k]} on the CPU")

    net = load_actor_critic(PARAMS, device=dev)  # bf16 trunk, as the JAX evaluation ran
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = evaluate_policy(greedy_logits(net), EVAL_EPISODES, EngineConfig(), prng_key(EVAL_SEED),
                            max_steps=EVAL_MAX_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    emit({"phase": "main_path", "stats": stats, "launches": launches, "seconds": wall,
          "ms_per_iteration": 1e3 * wall / max(stats["iterations"], 1),
          "small_fp32_equal_cpu": small["cuda"], "jax_reference_lines": JAX_LINES})
    it = stats["iterations"]
    if launches != {**{k: 0 for k in launches}, "turbo_step": it, "turbo_step_obs": it,
                    "observe_board": 1, "turbo_init": 1}:
        raise AssertionError(f"launch counts {launches} do not match {it} iterations")
    if not stats["lines_mean"] >= MIN_LINES or stats["episodes_completed"] < 500:
        raise AssertionError(f"the policy played below the gate: {stats}")
    for k, v in stats.items():
        if v != v or abs(v) == float("inf"):
            raise AssertionError(f"stat {k} is not finite: {v}")

    # -- 6. times ----------------------------------------------------------------
    def state_bytes(s):
        return nbytes(*(getattr(s, k) for k in turbo.FIELDS))

    def time_kernels(B, cfg, n_kernel, n_plain):
        s = kernels.turbo_init(batch_keys(prng_key(1), B, device=dev), cfg, turbo.PIECES)
        # a state in mid-game: 40 random steps in
        for _ in range(40):
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            s = kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping())[0]
        a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
        keys = batch_keys(prng_key(2), B, device=dev)
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
        step_io = 2 * state_bytes(s) + nbytes(a) + B * (4 + 1 + 4)
        fns = {
            "turbo_step": (lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping()),
                           lambda: turbo.step_plain(s, a, cfg), step_io),
            # the main paths' launch: the step and its board observation
            "turbo_step_obs": (
                lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping(), obs=obs),
                lambda: turbo.observe_board_plain(turbo.step_plain(s, a, cfg)[0], cfg),
                step_io + nbytes(obs)),
            "turbo_init": (lambda: kernels.turbo_init(keys, cfg, turbo.PIECES),
                           lambda: turbo.init_plain(keys, cfg),
                           nbytes(keys) + state_bytes(s)),
            "observe_board": (lambda: kernels.observe_board(s, cfg, turbo.PIECES),
                              lambda: turbo.observe_board_plain(s, cfg),
                              nbytes(s.rows[: cfg.height], s.piece, s.rotation, s.x, s.y,
                                     s.game_over) + B * cfg.height * cfg.width),
        }
        out = {}
        for name, (kernel_fn, plain_fn, io) in fns.items():
            out[name] = {
                "ms": device_ms(kernel_fn, n_kernel),
                "plain_ms": device_ms(plain_fn, n_plain),
                "call_ms": call_ms(kernel_fn, n_kernel),
                "plain_call_ms": call_ms(plain_fn, n_plain),
                "bytes": io,
            }
        out["turbo_step"]["lanes"] = kernels.step_lanes(B)
        out["turbo_step_obs"]["lanes"] = kernels.step_lanes(B, cfg.height * cfg.width)
        for lanes in kernels.STEP_LANES:  # each build, whichever the wrapper takes at this B
            out[f"turbo_step_lanes{lanes}"] = {"ms": device_ms(
                lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping(), lanes=lanes),
                n_kernel), "bytes": step_io}
            out[f"turbo_step_obs_lanes{lanes}"] = {"ms": device_ms(
                lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping(), obs=obs,
                                           lanes=lanes), n_kernel), "bytes": step_io + nbytes(obs)}
        for v in out.values():
            v["bound_ms"] = 1e3 * v["bytes"] / HBM_BYTES_PER_S
            v["bound_by"] = "bytes"
        return out

    # the least launch the card takes (a CUDA graph of empty spins), and the
    # least for a kernel that reads and writes once (a copy of 8192 floats)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    src, dst = torch.zeros(TRAIN_ENVS, device=dev), torch.empty(TRAIN_ENVS, device=dev)
    copy_ms = device_ms(lambda: dst.copy_(src), 200)
    emit({"phase": "launch_floor", "ms": floor_ms, "copy_8192_floats_ms": copy_ms,
          "nvidia_smi": smi})
    times = {}
    for B, cfg in ((EVAL_EPISODES, EngineConfig()), (TRAIN_ENVS, EngineConfig(auto_reset=True)),
                   (GROUPED_ENVS, EngineConfig(gravity_enabled=False, auto_reset=True)),
                   (65536, EngineConfig(auto_reset=True))):
        times[B] = time_kernels(B, cfg, n_kernel=200, n_plain=10)
        emit({"phase": "times", "B": B, "auto_reset": cfg.auto_reset,
              "gravity": cfg.gravity_enabled, "kernels": times[B],
              "env_steps_per_s": B / (times[B]["turbo_step"]["ms"] * 1e-3),
              "nvidia_smi": smi})
    # the CNN DQN's engine: 1024 envs with gravity and auto-reset
    times["dqn"] = time_kernels(DQN_ENVS, EngineConfig(auto_reset=True), n_kernel=200, n_plain=10)
    emit({"phase": "times", "B": DQN_ENVS, "path": "dqn", "auto_reset": True, "gravity": True,
          "kernels": times["dqn"], "nvidia_smi": smi})

    # where an iteration of the main path goes, at its shape
    cfg = EngineConfig()
    s = kernels.turbo_init(batch_keys(prng_key(EVAL_SEED), EVAL_EPISODES, device=dev), cfg,
                           turbo.PIECES)
    obs = kernels.observe_board(s, cfg, turbo.PIECES)
    act = greedy_logits(net)
    with torch.inference_mode():
        net_device = device_ms(lambda: net(obs), 50)
    net_call = call_ms(lambda: act(obs), 50)
    t512 = times[EVAL_EPISODES]
    emit({"phase": "breakdown", "B": EVAL_EPISODES, "iteration_ms": 1e3 * wall / max(it, 1),
          "policy_call_ms": net_call, "policy_device_ms": net_device,
          "turbo_step_obs_call_ms": t512["turbo_step_obs"]["call_ms"],
          "device_ms_per_iteration": net_device + t512["turbo_step_obs"]["ms"],
          "nvidia_smi": smi})

    # -- 7.-10. the training slice ------------------------------------------------
    check_ppo_kernels(dev)
    check_small_train_step()
    train = train_full_width(dev, smi)
    ppo_times = time_ppo_kernels(dev, smi)

    # -- 11.-16. the grouped DQN slice ---------------------------------------------
    check_grouped_placements(dev)
    check_act_and_randint(dev)
    check_replay(dev)
    check_small_grouped()
    grouped = train_grouped_full_width(dev, smi)
    grouped_times = time_grouped_kernels(dev, smi)

    # -- 17.-20. the CNN DQN slice ---------------------------------------------------
    check_dqn_kernels(dev)
    check_small_dqn()
    dqn_runs = {K: train_dqn_full_width(dev, smi, K) for K in (4, 1)}
    dqn_times = time_dqn_kernels(dev, smi)

    # -- 21.-25. the pixel CNN DQN slice ----------------------------------------------
    check_flagship(dev)
    flag_eval = eval_flagship_board(dev, net, stats)
    check_small_pixel_dqn()
    pix = train_pixel_dqn_full_width(dev, smi)
    pix_times = time_pixel_kernels(dev, smi)

    # -- 26.-30. the Gymnasium surface --------------------------------------------------
    check_surface_kernels(dev)
    shell = check_shell(dev)
    grouped_engine = run_grouped_engine(dev, smi)
    vector = run_vector_env(dev, smi)
    surface_times = time_surface_kernels(dev, smi)

    # -- 31.-34. wide boards and other geometries ----------------------------------------
    check_wide_kernels(dev)
    check_wide_cross_engine(dev)
    wide_vector = run_vector_env(dev, smi, WIDE_VECTOR)
    wide_times = time_wide_kernels(dev, smi)

    # -- 35.-39. the Gymnasium surface and both grouped engines at any geometry -----------
    check_surface_geometries(dev)
    check_grouped_engines_wide(dev)
    wide_shell = check_shell(dev, SHELL_WIDE)
    wide_grouped = run_grouped_engines_wide(dev, smi)
    surface_wide_times = time_surface_wide(dev, smi)

    # -- 40.-43. the compat functional engine and the exact grayscale --------------------
    check_gray_exact(dev)
    check_fn_kernels(dev)
    fn_path = run_fn_path(dev, smi)
    fn_times = time_fn_kernels(dev, smi)

    # -- 44.-47. PPO on the pixel chain; the from-scratch PPO curve --------------------------
    check_small_pixel_ppo()
    pix_ppo = train_pixel_ppo_full_width(dev, smi)
    pix_ppo_times = pixel_ppo_path_kernels(dev, smi, pix_ppo.pop("ts"))
    check_ppo_curve(dev, smi)

    # -- 48.-51. multi-device: the three sampling kernels at a global counter
    # offset; the sharded rollouts, PPO and DQN at W = 1 (NCCL) and W = 2
    # (gloo, both ranks on this card) against the unsharded runs ----------------
    offset_times = check_offset_kernels(dev, smi)
    sharded = run_sharded(dev, smi)

    # -- 52.-55. the utilities: video, checkpoint evaluation, whole-state
    # checkpoints, the trainers' logging flags and the profiler -----------------
    videos = check_video(dev, smi)
    eval_ckpt = check_evaluate_checkpoint(dev, smi, stats)
    resumed = check_resume(dev, smi)
    check_trainer_flags(dev, smi, resumed.pop("ts"), resumed.pop("train_step"))

    # -- 56. the port's wheel, installed outside the tree ------------------------------------
    check_wheel(smi)

    sources = {
        "turbo_step": ("tetris_gymnasium_torch/csrc/turbo_step.cu",
                       "tetris_gymnasium_tpu/core/turbo.py:639"),
        "turbo_init": ("tetris_gymnasium_torch/csrc/turbo_step.cu",
                       "tetris_gymnasium_tpu/core/turbo.py:440"),
        "observe_board": ("tetris_gymnasium_torch/csrc/observe_board.cu",
                          "tetris_gymnasium_tpu/core/turbo.py:738"),
        "gae": ("tetris_gymnasium_torch/csrc/gae.cu", "tetris_gymnasium_tpu/rl/ppo.py:147"),
        "ppo_sample": ("tetris_gymnasium_torch/csrc/ppo_sample.cu",
                       "tetris_gymnasium_tpu/rl/ppo.py:184"),
        "grouped_placements": ("tetris_gymnasium_torch/csrc/grouped_placements.cu",
                               "tetris_gymnasium_tpu/core/turbo_grouped.py:103"),
        "grouped_act": ("tetris_gymnasium_torch/csrc/grouped_act.cu",
                        "tetris_gymnasium_tpu/rl/grouped_dqn.py:165"),
        "replay_add": ("tetris_gymnasium_torch/csrc/replay.cu",
                       "tetris_gymnasium_tpu/rl/buffers.py:46"),
        "replay_sample": ("tetris_gymnasium_torch/csrc/replay.cu",
                          "tetris_gymnasium_tpu/rl/buffers.py:70"),
        "replay_sample_stacked": ("tetris_gymnasium_torch/csrc/replay.cu",
                                  "tetris_gymnasium_tpu/rl/buffers.py:111"),
        "framestack_push": ("tetris_gymnasium_torch/csrc/framestack.cu",
                            "tetris_gymnasium_tpu/ops/framestack.py:37"),
        "dqn_act": ("tetris_gymnasium_torch/csrc/dqn_act.cu", "tetris_gymnasium_tpu/rl/dqn.py:143"),
        "flagship_step": ("tetris_gymnasium_torch/csrc/flagship_step.cu",
                          "tetris_gymnasium_tpu/core/engine.py:451"),
        "flagship_init": ("tetris_gymnasium_torch/csrc/flagship_step.cu",
                          "tetris_gymnasium_tpu/core/engine.py:131"),
        "flagship_observe_board": ("tetris_gymnasium_torch/csrc/flagship_step.cu",
                                   "tetris_gymnasium_tpu/core/engine.py:274"),
        "render_rgb84": ("tetris_gymnasium_torch/csrc/render_rgb84.cu",
                         "tetris_gymnasium_tpu/core/engine.py:529"),
        "grouped_flagship": ("tetris_gymnasium_torch/csrc/grouped_flagship.cu",
                             "tetris_gymnasium_tpu/core/grouped.py:98"),
        "feature_vector": ("tetris_gymnasium_torch/csrc/features.cu",
                           "tetris_gymnasium_tpu/ops/observations.py:57"),
        "observe_dict": ("tetris_gymnasium_torch/csrc/observe_dict.cu",
                         "tetris_gymnasium_tpu/core/engine.py:257"),
        "compose_rgb": ("tetris_gymnasium_torch/csrc/observe_dict.cu",
                        "tetris_gymnasium_tpu/ops/observations.py:84"),
        "heights": ("tetris_gymnasium_torch/csrc/heights.cu",
                    "tetris_gymnasium_tpu/core/turbo.py:760"),
        "fn_reset": ("tetris_gymnasium_torch/csrc/fn_env.cu", "tetris_gymnasium_tpu/core/fn_env.py:210"),
        "fn_step": ("tetris_gymnasium_torch/csrc/fn_env.cu", "tetris_gymnasium_tpu/core/fn_env.py:189"),
        "fn_observe": ("tetris_gymnasium_torch/csrc/fn_env.cu", "tetris_gymnasium_tpu/core/fn_env.py:64"),
        "grayscale_u8_exact": ("tetris_gymnasium_torch/csrc/gray_exact.cu",
                               "tetris_gymnasium_tpu/ops/image.py:176"),
    }
    # Each kernel's launches and time come from one path: the first below
    # that runs it (the pixel DQN, else the flagship engine's board
    # evaluation, else the K = 4 DQN, else the K = 1 DQN, else the grouped
    # DQN, else PPO, else pixel PPO, else the batched flagship grouped
    # engine, else the Gymnasium shell, else each mode of its grouped
    # wrapper, else its observation wrappers), its time at that path's
    # shapes: the pixel DQN's 512 envs (7056-byte frames, 512 samples of the
    # 262,144-entry buffer), the evaluation's 512, the board DQN's 1024 envs
    # with gravity (512 samples), the grouped step's 1024 envs without
    # gravity (256 samples), the PPO step's B = 8192, the pixel PPO step's
    # 2048, the grouped engine's 4096 envs (features), the shell's B = 1; a
    # wrapper path's feature_vector and compose_rgb also by batch (B = 1 and
    # the 40 or 120 candidates, on_paths' by_batch).
    # TetrisVectorEnv's paths (8192 envs, 10x20 and 30x20) give their kernels'
    # times too, so that each entry's on_paths counts their launches.
    pix_at = {name: pix_times[name][PIX_ENVS] for name in
              ("flagship_step", "flagship_init", "render_rgb84", "framestack_push", "dqn_act")}
    pix_at.update(replay_add=pix_times["replay_add"],
                  replay_sample_stacked=pix_times["replay_sample_stacked"][PIX_BATCH])
    flag_at = {"flagship_observe_board": pix_times["flagship_observe_board"][EVAL_EPISODES]}
    dqn_at = {"turbo_step": times["dqn"]["turbo_step_obs"], "turbo_init": times["dqn"]["turbo_init"],
              "observe_board": times["dqn"]["observe_board"],
              "framestack_push": dqn_times["framestack_push"][DQN_ENVS],
              "dqn_act": dqn_times["dqn_act"][DQN_ENVS], "replay_add": dqn_times["replay_add"],
              "replay_sample_stacked": dqn_times["replay_sample_stacked"][DQN_BATCH],
              "replay_sample": dqn_times["replay_sample"]}
    grouped_at = {"grouped_placements": grouped_times["grouped_placements"][f"features@{GROUPED_ENVS}"],
                  "grouped_act": grouped_times["grouped_act"][GROUPED_ENVS],
                  "turbo_init": grouped_times["turbo_init"],
                  "replay_sample": grouped_times["replay_sample"][256]}
    paths = [("dqn_rgb84", pix["launches"], PIX_STEPS, pix_at),
             ("flagship_eval", flag_eval["launches"], flag_eval["iterations"], flag_at),
             ("dqn_k4", dqn_runs[4]["launches"], DQN_STEPS, dqn_at),
             ("dqn_k1", dqn_runs[1]["launches"], DQN_STEPS, dqn_at),
             ("grouped_train", grouped["launches"], GROUPED_STEPS, grouped_at),
             ("ppo_train", train["launches"], TRAIN_STEPS,
              {**times[TRAIN_ENVS], "turbo_step": times[TRAIN_ENVS]["turbo_step_obs"],
               **ppo_times[TRAIN_ENVS]}),
             # pixel PPO launches flagship_step's sampling build
             ("ppo_rgb84", pix_ppo["launches"], PIX_PPO_STEPS,
              {**pix_ppo_times, "flagship_step": pix_ppo_times["flagship_step_sample"]}),
             ("grouped_engine", grouped_engine["launches"], grouped_engine["steps"],
              {"grouped_flagship": surface_times["grouped_flagship"][f"features@{GROUPED_ENGINE_B}"]}),
             # the Gymnasium shell, each grouped wrapper mode and each
             # observation wrapper a path of its own (phases 27 and 37)
             *_wrapper_paths(shell["runs"], "", {k: surface_times[k] for k in ("observe_dict", "compose_rgb",
                                                                                 "feature_vector")}),
             ("vector_env", vector["launches"], vector["steps"],
              {k: wide_times["default"][k][VECTOR_B] for k in VECTOR_ENV_KERNELS}),
             ("vector_env_wide", wide_vector["launches"], wide_vector["steps"],
              {k: wide_times["30x20"][k][VECTOR_B] for k in VECTOR_ENV_KERNELS}),
             *_wrapper_paths(wide_shell["runs"], "_wide",
                             {k: surface_wide_times["30x20"][k] for k in ("compose_rgb", "feature_vector")}),
             ("grouped_engines_wide", wide_grouped["launches"], wide_grouped["steps"], {}),
             ("fn_rollout", fn_path["launches"], fn_path["steps"],
              {k: fn_times[k][FN_PATH_B] for k in ("fn_reset", "fn_step")}),
             # heights, fn_observe (fn_step and fn_reset write their own
             # observations), grayscale_u8_exact and ppo_sample (every PPO
             # route samples in its step's launch): no path calls them;
             # heights' time is at 30x20, B = 4096, fn_observe's at B =
             # 65536, grayscale_u8_exact's over 2**24 pixels, ppo_sample's
             # at pixel PPO's B = 2048, their launches 0
             ("none", {k: 0 for k in kernels.LAUNCHES}, 1,
              {"heights": wide_times["30x20"]["heights"][4096], "fn_observe": fn_times["fn_observe"][FN_PATH_B],
               "grayscale_u8_exact": fn_times["grayscale_u8_exact"][GRAY_ALL],
               "ppo_sample": pix_ppo_times["ppo_sample"]})]
    # the builds inside a library: turbo_step's lanes, observation and
    # sample; gae's two copy schemes (times at the training's B = 8192)
    variants = {
        "turbo_step": {
            **{f"lanes{L}{tag}": None for L in kernels.STEP_LANES for tag in ("", "+obs")},
            **{f"lanes{L}+obs+sample": ppo_times[TRAIN_ENVS][f"sample_step_lanes{L}"]["ms"]
               for L in kernels.STEP_LANES}},
        "gae": {b: ppo_times[TRAIN_ENVS][f"gae_{b}"]["ms"] for b in kernels.GAE_BUILDS},
    }
    # flagship_step's lanes builds at the pixel DQN's B = 512 (phase 25) and
    # pixel PPO's 2048 (phase 46; with the sample too, "lanes16+sample")
    flagship_builds = {PIX_ENVS: {"flagship_step": pix_times["flagship_step"][PIX_ENVS]["builds_ms"]},
                       PIX_PPO_ENVS: {"flagship_step": pix_ppo_times["flagship_step"]["builds_ms"]}}
    # each kernel's builds (phase 2: one library per geometry for the
    # sources of kernels.GEOMETRY_SOURCES and features.cu), and the surface
    # kernels' times at 30x20 and 61x12 (phase 39)
    builds_of = {}
    for b in builds:
        builds_of.setdefault(b["name"], []).append(
            ",".join(f"{k[7:].lower()}={v}" for k, v in b["defines"].items()) or "default")
    wide_at = {k: {geo: {key: {f: e[f] for f in ("ms", "bound_ms", "bound_by", "plain_ms")}
                         for key, e in by_kernel[k].items()}
                   for geo, by_kernel in surface_wide_times.items()} for k in SURFACE_KERNELS}
    entries = []
    for name, (src, rep) in sources.items():
        path, counts, n_steps, at = next(p for p in paths if p[1][name] or p[0] == "none")
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "path": path,
            "launches": counts[name], "launches_per_step": counts[name] / n_steps,
            **{f"launches_{p[0]}": p[1][name] for p in paths if p[0] != "none"},
            "launches_eval": launches[name],
            "launches_dqn_eval_k4": dqn_runs[4]["eval_launches"][name],
            "launches_dqn_rgb84_eval": pix["eval_launches"][name],
            # each path that runs the kernel and timed it: its launches a step
            # (the vector env's steps are both engines' runs) and ms a launch
            "on_paths": {p[0]: {"launches_per_step": p[1][name] / p[2], "ms": p[3][name].get("ms"),
                                "bound_ms": p[3][name].get("bound_ms"),
                                **({"by_batch": p[3][name]["by_batch"]} if "by_batch" in p[3][name] else {})}
                         for p in paths if p[0] != "none" and p[1][name] and isinstance(p[3].get(name), dict)},
            "max_abs_err": MAX_ERR[name], "ms": at[name]["ms"], "plain_ms": at[name]["plain_ms"],
            "bound_ms": at[name]["bound_ms"], "bound_by": at[name].get("bound_by", "bytes"),
            "library_ms": at[name].get("library_ms"), "launch_floor_ms": floor_ms,
            **({"builds_ms_on_path": at[name]["builds_ms"]} if "builds_ms" in at[name] else {}),
            **({"greedy_ms": at[name]["greedy_ms"]} if "greedy_ms" in at[name] else {}),
            # dqn_act: a Python call's host time with keys (the split made on the card)
            **({"call_ms": at[name]["call_ms"]} if name == "dqn_act" else {}),
            # fn_reset: its time at each batch of phase 43 (B = 1 is the example's game)
            **({"ms_by_batch": {B: fn_times[name][B]["ms"] for B in FN_TIME_B}} if name == "fn_reset" else {}),
            "builds": builds_of[os.path.splitext(os.path.basename(src))[0]],
            **({"wide": wide_at[name]} if name in wide_at else {}),
            **({"variants_ms_at_8192": variants[name]} if name in variants else {}),
            **({f"variants_ms_at_{B}": {f"lanes{L}": ms for L, ms in by_b[name].items()}
                for B, by_b in flagship_builds.items() if name in by_b}),
        })
        if name == "turbo_step":  # its sampling build on the PPO path (phase 9)
            entries[-1]["launches_sample_ppo_train"] = train["launches"]["turbo_step_sample"]
        if name == "flagship_step":  # its sampling build on the pixel PPO path (phase 45)
            entries[-1]["launches_sample_ppo_rgb84"] = pix_ppo["launches"]["flagship_step_sample"]
        # launches a rank made on the sharded paths (phases 49-51, W = 2)
        entries[-1].update({f"launches_{p}": c[name] for p, c in sharded["launches"].items()})
        # the utilities' paths: one recorded episode (seed 0, the default
        # board, phase 52), the checkpoint evaluation (phase 53) and the
        # resumed PPO step (phase 54)
        entries[-1].update(launches_video_episode=videos["launches"][name],
                           video_episode_frames=videos["frames"],
                           launches_evaluate_checkpoint=eval_ckpt["launches"][name],
                           launches_ppo_resumed_step=resumed["launches"][name])
        timed = {"turbo_step": "turbo_step_sample", "flagship_step": "flagship_step_sample"}.get(name, name)
        if timed in offset_times:  # phase 48: at global counter offsets 0 and 3B
            entries[-1]["offset_ms"] = {
                B: {k: v["ms"] for k, v in by_off.items()}
                for B, by_off in offset_times[timed].items()}
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _wrapper_paths(runs, suffix, times) -> list:
    """The kernels line's paths of :func:`check_shell`'s runs: each run's
    launches and steps, and for each kernel that ``times`` holds by batch
    (``{kernel: {B: entry}}``) its entry at the run's smallest batch, with
    ``by_batch``: the run's launches a step, ms and bound at each batch it
    launched (``feature_vector`` and ``compose_rgb``: B = 1 and the
    candidates); ``observe_dict`` at B = 1."""
    out = []
    for r in runs:
        at = {}
        for kernel, by_b in times.items():
            counts = {int(k.split("@")[1]): v for k, v in r["batches"].items() if k.split("@")[0] == kernel and v}
            if kernel == "observe_dict" and r["launches"][kernel]:
                counts = {1: r["launches"][kernel]}
            if not counts or any(B not in by_b for B in counts):
                continue
            at[kernel] = {**by_b[min(counts)], "by_batch": {
                B: {"launches_per_step": n / r["steps"], "ms": by_b[B]["ms"], "bound_ms": by_b[B]["bound_ms"]}
                for B, n in sorted(counts.items())}}
        out.append((r["path"] + suffix, r["launches"], r["steps"], at))
    return out


def check_ppo_kernels(dev) -> None:
    """Phase 7: ``gae`` and ``ppo_sample`` against their plain versions."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import ppo

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    t0 = time.perf_counter()
    gae_runs = []
    shapes = [(T, B, p) for T in GAE_CHECK_T for B in GAE_CHECK_B for p in (0.0, 1 / 200, 1.0)]
    for T, B, p_done in shapes + [(TRAIN_T, 1000, 0.3), (5, 8191, 1 / 200)]:
        reward = torch.randn((T, B), generator=g, device=dev)
        value = torch.randn((T, B), generator=g, device=dev) * 10
        done = torch.rand((T, B), generator=g, device=dev) < p_done
        last = torch.randn((B,), generator=g, device=dev) * 10
        want = ppo.gae_plain(reward, value, done, last, 0.999, 0.95)
        taken = kernels.gae_build(B, reward, value, done, reward, value)
        if taken != ("tma" if B % 16 == 0 else "cp_async"):
            raise AssertionError(f"gae takes the {taken} build at B = {B}")
        # both builds where every row lies on 16 bytes, the cp.async build elsewhere
        for build in kernels.GAE_BUILDS if taken == "tma" else ("cp_async",):
            got = kernels.gae(reward, value, done, last, 0.999, 0.95, build=build)
            what = f"gae ({build}) T={T} B={B} p_done={p_done}"
            diff("gae", got[0], want[0], f"{what} advantages")
            diff("gae", got[1], want[1], f"{what} targets")
            gae_runs.append({"T": T, "B": B, "p_done": p_done, "build": build})

    sample_runs = []
    worst_ulps = 0
    lp_bit_equal = True
    for B, n_keys in ((TRAIN_ENVS, 16), (1, 4), (1001, 4)):
        counters = torch.arange(B * 8, dtype=torch.int64, device=dev).reshape(B, 8)
        for scale in ("near-ties", 1.0, 30.0):
            if scale == "near-ties":  # many logits equal, the rest 2**-20 apart
                logits = torch.randint(0, 3, (B, 8), generator=g, device=dev).float() * 2**-20
            else:
                logits = torch.randn((B, 8), generator=g, device=dev) * scale
            for i in range(n_keys):
                key = threefry.fold_in(threefry.prng_key(11), i)
                a, lp, u = kernels.sample_actions(logits, key, return_uniforms=True)
                pa, plp = ppo.sample_actions_plain(logits, key)
                pu = threefry.bits_to_uniform_lanes(threefry.random_bits32_lanes(key, counters),
                                                    threefry.TINY, 1.0)
                diff("ppo_sample", u, pu, f"uniforms B={B} scale={scale} key {i}")
                diff("ppo_sample", a, pa, f"actions B={B} scale={scale} key {i}")
                err = (lp.double() - plp.double()).abs()
                MAX_ERR["ppo_sample"] = max(MAX_ERR["ppo_sample"], float(err.max()))
                ulp = torch.from_numpy(np.spacing(plp.abs().cpu().numpy())).to(dev).double()
                tol = 2.0**-22 + LOG_PROB_ULPS * ulp
                if bool((err > tol).any()):
                    raise AssertionError(f"log_prob B={B} scale={scale} key {i}: max error "
                                         f"{float(err.max())} beyond the logf/expf bound")
                worst_ulps = max(worst_ulps, int((err / ulp).max()))
                lp_bit_equal &= torch.equal(bits(lp), bits(plp))
        sample_runs.append({"B": B, "keys": n_keys})
    torch.cuda.synchronize()
    emit({"phase": "ppo_kernels", "gae_bit_equal": True, "gae_runs": len(gae_runs),
          "gae_shapes": {b: sorted({(r["T"], r["B"]) for r in gae_runs if r["build"] == b})
                         for b in kernels.GAE_BUILDS},
          "sample_uniforms_bit_equal": True, "sample_actions_equal": True,
          "sample_log_prob_bit_equal": lp_bit_equal, "sample_log_prob_max_ulps": worst_ulps,
          "sample_runs": sample_runs, "max_abs_err": {k: MAX_ERR[k] for k in ("gae", "ppo_sample")},
          "seconds": time.perf_counter() - t0})


def check_small_train_step() -> None:
    """Phase 8: a small fp32 train step on the card against the same step on the CPU."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.models.networks import ActorCriticCNN
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    cfg = ppo.PPOConfig(rollout_len=8, update_epochs=2, n_minibatches=2)
    env_config = EngineConfig(auto_reset=True)
    start = load_flat(PARAMS)
    out = {}
    with deterministic_cudnn():
        for where in ("cuda", "cpu"):
            ts = ppo.init_train_state(prng_key(0), 64, env_config, cfg,
                                      net=ActorCriticCNN(dtype=torch.float32), device=where,
                                      params=start)
            traj = ppo.rollout(ts, cfg, ppo.sample_step_fn(env_config))[0]
            ts, metrics = ppo.make_train_step(env_config, cfg)(ts)
            out[where] = (traj, to_flax_params(ts.net.state_dict()),
                          {k: float(v) for k, v in metrics.items()})
    (tc, pc, mc), (tp, pp, mp) = out["cuda"], out["cpu"]
    for k in ("obs", "action", "reward", "done"):
        if not torch.equal(getattr(tc, k).cpu(), getattr(tp, k)):
            raise AssertionError(f"small train step: rollout {k} differs between card and CPU")
    norm_worst, elem_worst = param_change_diff("small train step", start, pc, pp,
                                               SMALL_TRAIN_PARAM_TOL)
    emit({"phase": "small_train_step", "rollout_bit_equal": True,
          "param_change_max_norm_rel_diff": norm_worst,
          "param_change_max_elem_rel_diff": elem_worst, "metrics_cuda": mc, "metrics_cpu": mp,
          "seconds": time.perf_counter() - t0})


def train_full_width(dev, smi) -> dict:
    """Phase 9: the training path at full width, then its checks."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.examples import train_ppo
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.rl.evaluate import evaluate_policy, greedy_logits
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    args = train_ppo.parse_args(TRAIN_ARGV)
    events = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, []).append(ev)

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, records = train_ppo.train(args, marks=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # each rollout step one turbo_step launch that samples, steps and
    # observes; ppo_sample runs on the flagship route only
    want = {**{k: 0 for k in launches}, "turbo_init": 1, "turbo_step": TRAIN_STEPS * TRAIN_T,
            "turbo_step_obs": TRAIN_STEPS * TRAIN_T, "turbo_step_sample": TRAIN_STEPS * TRAIN_T,
            "observe_board": 1, "gae": TRAIN_STEPS, "ppo_sample": 0}
    if launches != want:
        raise AssertionError(f"training launch counts {launches}, want {want}")

    rec = records[-1]
    for k, v in rec.items():
        if not np.isfinite(v):
            raise AssertionError(f"training metric {k} is not finite: {v}")
    start = load_flat(PARAMS)
    trained = to_flax_params(ts.net.state_dict())
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in start}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"some parameters did not move: {moved}")

    steps = []
    for i in range(TRAIN_STEPS):
        split = {"rollout_ms": events["start"][i].elapsed_time(events["rollout"][i]),
                 "gae_ms": events["rollout"][i].elapsed_time(events["gae"][i]),
                 "update_ms": events["gae"][i].elapsed_time(events["update"][i])}
        split["step_ms"] = events["start"][i].elapsed_time(events["update"][i])
        split["env_steps_per_s"] = TRAIN_ENVS * TRAIN_T / (split["step_ms"] * 1e-3)
        steps.append(split)
    emit({"phase": "train", "n_envs": TRAIN_ENVS, "rollout_len": TRAIN_T,
          "train_steps": TRAIN_STEPS, "record": rec, "launches": launches,
          "wall_s_with_setup": wall, "steps": steps, "param_max_change": moved,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "nvidia_smi": smi})

    # 512 greedy games of the trained weights
    t0 = time.perf_counter()
    stats = evaluate_policy(greedy_logits(ts.net), EVAL_EPISODES, EngineConfig(),
                            prng_key(EVAL_SEED), max_steps=EVAL_MAX_STEPS, device=dev)
    if not stats["lines_mean"] >= MIN_LINES or stats["episodes_completed"] < 500:
        raise AssertionError(f"the trained policy played below the gate: {stats}")

    # One more rollout; its first minibatch checks the gradient's sign.
    # (a) The training update (full loss, the run's Adam) must lower the full
    # loss of that minibatch.  (b) The value term dominates that loss here
    # (the committed value head was trained on other rewards), so the
    # clipped surrogate's own gradient g is checked by a central difference:
    # surrogate(w - eta*g) < surrogate(w + eta*g), with eta moving no weight
    # by more than the run's learning rate.  A fresh Adam step of the
    # surrogate alone moves every weight by about the learning rate, which
    # overshoots this near-deterministic policy; it is reported at lr and
    # lr / 10, not gated.
    cfg = ppo.PPOConfig(rollout_len=TRAIN_T, ent_coef=0.004, learning_rate=4e-5)
    sample_step = ppo.sample_step_fn(EngineConfig(auto_reset=True))
    traj, _, last_obs, key = ppo.rollout(ts, cfg, sample_step)
    with torch.no_grad():
        _, last_value = ts.net(last_obs)
    adv, tgt = ppo.gae(cfg, traj, last_value)
    _, perm_keys = ppo.epoch_keys(key, 1)
    batch, b_adv, b_tgt = next(ppo.minibatches(traj, adv, tgt, cfg, perm_keys))

    def losses(net):
        with torch.no_grad():
            total, (pg, _, _) = ppo.loss_fn(net, cfg, batch, b_adv, b_tgt, cfg.ent_coef)
        return total.item(), pg.item()

    def surrogate_grads(net):
        net.zero_grad()
        ppo.loss_fn(net, cfg, batch, b_adv, b_tgt, cfg.ent_coef)[1][0].backward()
        return [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in net.parameters()]

    def shifted(net, grads, step):
        out = copy.deepcopy(net)
        with torch.no_grad():
            for p, gr in zip(out.parameters(), grads):
                p.add_(gr, alpha=step)
        return out

    probe = {"minibatch": int(batch.action.shape[0])}
    probe["total_before"], probe["surrogate_before"] = losses(ts.net)
    grads = surrogate_grads(ts.net)
    eta = cfg.learning_rate / max(float(gr.abs().max()) for gr in grads)
    probe["surrogate_minus_eta_g"] = losses(shifted(ts.net, grads, -eta))[1]
    probe["surrogate_plus_eta_g"] = losses(shifted(ts.net, grads, eta))[1]
    for lr in (cfg.learning_rate, cfg.learning_rate / 10):
        net = copy.deepcopy(ts.net)
        opt = ppo.make_optimizer(cfg._replace(learning_rate=lr), net.parameters())
        surrogate_grads(net)
        opt.step()
        probe[f"surrogate_after_surrogate_adam_lr{lr:g}"] = losses(net)[1]
    loss = ppo.loss_fn(ts.net, cfg, batch, b_adv, b_tgt, cfg.ent_coef)[0]
    ts.optimizer.zero_grad()
    loss.backward()
    ts.optimizer.step()
    probe["total_after"], probe["surrogate_after"] = losses(ts.net)
    emit({"phase": "train_checks", "eval_after_training": stats, "gradient_sign_probe": probe,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    if not probe["total_after"] < probe["total_before"]:
        raise AssertionError(f"the training update raised its minibatch's loss: {probe}")
    if not probe["surrogate_minus_eta_g"] < probe["surrogate_plus_eta_g"]:
        raise AssertionError(f"the surrogate rises against its gradient: {probe}")

    # where the update's time goes: one minibatch at a time, CUDA events between parts
    marks = []

    def part(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    batches = ppo.minibatches(traj, adv, tgt, cfg, perm_keys)
    for _ in range(4):
        part("start")
        b, ba, bt = next(batches)
        part("gather")
        total, _ = ppo.loss_fn(ts.net, cfg, b, ba, bt, cfg.ent_coef)
        part("forward")
        ts.optimizer.zero_grad()
        total.backward()
        part("backward")
        ts.optimizer.step()
        part("optimizer")
    torch.cuda.synchronize()
    parts = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name != "start":
            parts[name] = parts.get(name, 0.0) + a.elapsed_time(b) / 4
    obs = traj.obs[0]
    with torch.no_grad():
        policy_ms = device_ms(lambda: ts.net(obs), 20)
        policy_call = call_ms(lambda: ts.net(obs), 20)
    emit({"phase": "train_breakdown", "minibatch_ms": parts, "policy_forward_device_ms": policy_ms,
          "policy_forward_call_ms": policy_call, "B": TRAIN_ENVS, "nvidia_smi": smi})
    return {"launches": launches, "steps": steps}


PPO_TIME_B = (2048, TRAIN_ENVS, 65536)  # the JAX example's --n-envs, the training's, the largest


def time_ppo_kernels(dev, smi) -> dict:
    """Phase 10: device times beside their bounds and the launch floor of
    ``gae`` (as the wrapper takes it and each build, T = 128), ``ppo_sample``,
    PPO's sampling step (``turbo_step`` sampling, stepping and observing in
    one launch, as the wrapper takes it and each lanes build) and the two
    launches it replaces (``ppo_sample``, then ``turbo_step`` with the
    observation, in one graph); the same for the flagship routes' sampling
    step (``flagship_step`` sampling and stepping in one launch) beside
    ``ppo_sample`` then ``flagship_step``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.rl import ppo

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    cfg, rw = EngineConfig(auto_reset=True), RewardsMapping()
    out = {}
    for B in PPO_TIME_B:
        T = TRAIN_T
        reward = torch.randn((T, B), generator=g, device=dev)
        value = torch.randn((T, B), generator=g, device=dev)
        done = torch.rand((T, B), generator=g, device=dev) < 1 / 200
        last = torch.randn((B,), generator=g, device=dev)
        logits = torch.randn((B, 8), generator=g, device=dev) * 3
        key = prng_key(5)
        s = kernels.turbo_init(batch_keys(prng_key(1), B, device=dev), cfg, turbo.PIECES)
        for _ in range(40):  # a state in mid-game
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            s = kernels.turbo_step(s, a, cfg, turbo.PIECES, rw)[0]
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
        step_io = (2 * nbytes(*(getattr(s, k) for k in turbo.FIELDS)) + B * (4 + 1 + 4)
                   + nbytes(obs))
        gae_io = nbytes(reward, value, done, last) + 2 * nbytes(reward)
        sample_io = nbytes(logits) + B * (4 + 4)
        fs = kernels.flagship_init(batch_keys(prng_key(1), B, device=dev), cfg, engine.PIECES)
        for _ in range(40):  # a state in mid-game
            fs = kernels.flagship_step(fs, _flagship_actions(B, g, dev), cfg, engine.PIECES, rw)[0]
        fstep_io = 2 * nbytes(*(getattr(fs, k) for k in engine.FIELDS)) + B * (4 + 1 + 4)

        def flagship_sample_step(lanes=None):
            return lambda: kernels.flagship_step(fs, None, cfg, engine.PIECES, rw, lanes=lanes,
                                                 logits=logits, act_key=key)

        def flagship_sample_step_plain():
            return engine.step_plain(fs, ppo.sample_actions_plain(logits, key)[0], cfg)

        def gae_fn(build=None):
            return lambda: kernels.gae(reward, value, done, last, 0.999, 0.95, build=build)

        def sample_step(lanes=None):
            return lambda: kernels.turbo_step(s, None, cfg, turbo.PIECES, rw, obs=obs, lanes=lanes,
                                              logits=logits, act_key=key)

        def sample_step_plain():
            pa, _ = ppo.sample_actions_plain(logits, key)
            return turbo.observe_board_plain(turbo.step_plain(s, pa, cfg)[0], cfg)

        gae_plain = lambda: ppo.gae_plain(reward, value, done, last, 0.999, 0.95)  # noqa: E731
        sample_plain = lambda: ppo.sample_actions_plain(logits, key)  # noqa: E731
        fns = {
            "gae": (gae_fn(), gae_plain, gae_io, GAE_OPS_PER_ELEMENT * T * B),
            "ppo_sample": (lambda: kernels.sample_actions(logits, key), sample_plain, sample_io,
                           SAMPLE_OPS_PER_ELEMENT * B * 8),
            "sample_step": (sample_step(), sample_step_plain, step_io + sample_io,
                            SAMPLE_OPS_PER_ELEMENT * B * 8),
            # the same work as the sampling step in two launches
            "ppo_sample_then_turbo_step_obs": (
                lambda: kernels.turbo_step(s, kernels.sample_actions(logits, key)[0], cfg,
                                           turbo.PIECES, rw, obs=obs),
                None, step_io + sample_io, SAMPLE_OPS_PER_ELEMENT * B * 8),
            # the flagship routes' sampling step, and the two launches it replaces
            "flagship_sample_step": (flagship_sample_step(), flagship_sample_step_plain,
                                     fstep_io + sample_io, SAMPLE_OPS_PER_ELEMENT * B * 8),
            "ppo_sample_then_flagship_step": (
                lambda: kernels.flagship_step(fs, kernels.sample_actions(logits, key)[0], cfg,
                                              engine.PIECES, rw),
                None, fstep_io + sample_io, SAMPLE_OPS_PER_ELEMENT * B * 8),
        }
        for build in kernels.GAE_BUILDS:
            fns[f"gae_{build}"] = (gae_fn(build), None, gae_io, GAE_OPS_PER_ELEMENT * T * B)
        for lanes in kernels.STEP_LANES:
            fns[f"sample_step_lanes{lanes}"] = (sample_step(lanes), None, step_io + sample_io,
                                                SAMPLE_OPS_PER_ELEMENT * B * 8)
        for lanes in kernels.FLAGSHIP_LANES:
            fns[f"flagship_sample_step_lanes{lanes}"] = (flagship_sample_step(lanes), None,
                                                         fstep_io + sample_io,
                                                         SAMPLE_OPS_PER_ELEMENT * B * 8)
        out[B] = {}
        for name, (kernel_fn, plain_fn, io, ops) in fns.items():
            bytes_ms, ops_ms = 1e3 * io / HBM_BYTES_PER_S, 1e3 * ops / OPS_PER_S
            n_plain = 3 if name.startswith("gae") else 10
            out[B][name] = {
                "ms": device_ms(kernel_fn, 100),
                "plain_ms": device_ms(plain_fn, n_plain) if plain_fn is not None else None,
                "call_ms": call_ms(kernel_fn, 100),
                "bytes": io, "operations": ops, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "launch_floor_ms": floor_ms,
            }
            if name.startswith(("gae", "sample_step", "ppo_sample_then", "flagship_sample_step")):
                out[B][name]["cold_ms"] = cold_device_ms(kernel_fn, 100, dev)
        out[B]["gae"]["build"] = kernels.gae_build(B, reward, value, done, reward, value)
        out[B]["sample_step"]["lanes"] = kernels.step_lanes(B, cfg.height * cfg.width)
        out[B]["flagship_sample_step"]["lanes"] = kernels.flagship_step_lanes(B, cfg.padded_height)
        emit({"phase": "ppo_times", "B": B, "T": TRAIN_T, "kernels": out[B],
              "launch_floor_ms": floor_ms, "nvidia_smi": smi})
        del reward, value, done, s, obs, fs
    return out


# ---------------------------------------------------------------------------
# 11.-16. the grouped DQN slice
# ---------------------------------------------------------------------------


def _grouped_actions(gs, g, dev, wild=0.1):
    """Random placements: a random legal candidate, or with probability
    ``wild`` any of the A candidates (so some are illegal)."""
    from tetris_gymnasium_torch.rl.grouped_dqn import act_plain

    A, B = gs.mask.shape
    a = act_plain(torch.randn((B, A), generator=g, device=dev), gs.mask.T)
    anything = torch.randint(0, A, (B,), generator=g, device=dev, dtype=torch.int32)
    return torch.where(torch.rand((B,), generator=g, device=dev) < wild, anything, a)


def check_grouped_placements(dev) -> None:
    """Phase 11: ``grouped_placements`` against its plain versions, both modes."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    t0 = time.perf_counter()
    comparisons = 0

    def compare(s, cfg, what, max_clears=(4,)):
        nonlocal comparisons
        for mode, plain in (("features", tg.placements_plain), ("boards", tg.placement_boards_plain)):
            for mc in max_clears:
                got = kernels.grouped_placements(s, cfg, turbo.PIECES, mc, mode)
                want = plain(s, cfg, max_clear=mc)
                for a, b, name in zip(got, want, ("obs", "mask", "game_over", "lines")):
                    diff("grouped_placements", a, b, f"{what} {mode} max_clear={mc} {name}")
                comparisons += 1

    runs = [
        ("autoreset-terminate", 4096, GROUPED_CHECK_STEPS,
         EngineConfig(gravity_enabled=False, auto_reset=True), True),
        ("autoreset-noop", 4096, GROUPED_CHECK_STEPS,
         EngineConfig(gravity_enabled=False, auto_reset=True), False),
        ("no-autoreset", 512, GROUPED_CHECK_STEPS, EngineConfig(gravity_enabled=False), True),
    ]
    summary = []
    for name, B, T, cfg, terminate in runs:
        gs, _ = tg.reset(batch_keys(prng_key(21), B, device=dev), cfg, device=dev)
        n_illegal = n_done = n_lines = 0
        for i in range(T):
            compare(gs.env, cfg, f"{name} @ {i}")
            a = _grouped_actions(gs, g, dev)
            n_illegal += int((gs.mask.gather(0, a.long()[None])[0] == 0).sum())
            gs, _, _, done, info = tg.step(gs, a, cfg, terminate_on_illegal=terminate)
            n_done += int(done.sum())
            n_lines += int(info["lines_cleared"].sum())
        summary.append({"run": name, "B": B, "steps": T, "illegal_actions": n_illegal,
                        "episodes_ended": n_done, "lines": n_lines})

    # hand-built boards: random stacks with 0..6 full rows and random pieces
    B = 4096
    cfg = EngineConfig(gravity_enabled=False)
    pad, height, width = cfg.padding, cfg.height, cfg.width
    s = kernels.turbo_init(batch_keys(prng_key(5), B, device=dev), cfg, turbo.PIECES)
    rows = turbo.u32_to_lanes(s.rows)
    garbage = torch.randint(0, 1 << width, (height - 8, B), generator=g, device=dev) << pad
    keep = torch.rand((height - 8, B), generator=g, device=dev) < 0.6
    rows[8:height] |= torch.where(keep, garbage, 0)
    n_full = torch.randint(0, 7, (B,), generator=g, device=dev)
    full = torch.arange(height, device=dev)[:, None] >= height - n_full
    rows[:height] |= torch.where(full, ((1 << width) - 1) << pad, 0)
    s = s.replace(rows=turbo.lanes_to_u32(rows).contiguous(),
                  piece=torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32),
                  rotation=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32))
    compare(s, cfg, "surgery", max_clears=(4, height))
    _, _, over4, _ = kernels.grouped_placements(s, cfg, turbo.PIECES, 4, "features")
    _, _, _, lines20 = kernels.grouped_placements(s, cfg, turbo.PIECES, height, "features")
    if not bool(over4[:, n_full >= 5].all()):
        raise AssertionError("a board with five full rows has a placement that is no game over "
                             "under max_clear=4")
    if int(lines20.max()) < 5:
        raise AssertionError("max_clear=20 cleared no 5-row stack")
    torch.cuda.synchronize()
    emit({"phase": "grouped_placements", "bit_equal": True, "runs": summary,
          "surgery_max_lines_max_clear_20": int(lines20.max()), "comparisons": comparisons,
          "max_abs_err": MAX_ERR["grouped_placements"], "seconds": time.perf_counter() - t0})


def check_act_and_randint(dev) -> None:
    """Phase 12: ``grouped_act`` and ``replay_sample``'s randint against their
    plain versions and JAX's bit mapping (the uniforms and offsets)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl.grouped_dqn import act_plain

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    t0 = time.perf_counter()
    A = 40
    act_runs = []
    for B in (1024, 4096, 1, 1001):
        for trial, scale in enumerate(("near-ties", 1.0, 30.0)):
            if scale == "near-ties":  # many Q values equal, the rest 2**-20 apart
                q = torch.randint(0, 3, (B, A), generator=g, device=dev).float() * 2**-20
            else:
                q = torch.randn((B, A), generator=g, device=dev) * scale
            mask_ab = (torch.rand((A, B), generator=g, device=dev) < 0.5).float()
            mask_ab[:, :: 7] = 0.0  # every seventh env has no legal candidate
            counters = torch.arange(B * A, dtype=torch.int64, device=dev).reshape(B, A)
            if trial == 2:  # NaNs among the candidates
                q[::3, ::7] = float("nan")
            # every lane width (and the wrapper's own choice), on the
            # engine's [A, B] mask transposed
            builds = (None,) + kernels.GROUPED_ACT_LANES
            for eps in (0.0, 0.3, 1.0):
                act_key, eps_key = threefry.split(threefry.fold_in(threefry.prng_key(B), trial))
                want = act_plain(q, mask_ab.T, act_key, eps_key, eps)
                want_nu = threefry.bits_to_uniform_lanes(
                    threefry.random_bits32_lanes(act_key, counters), threefry.TINY, 1.0)
                want_eu = threefry.bits_to_uniform_lanes(threefry.random_bits32_lanes(
                    eps_key, torch.arange(B, dtype=torch.int64, device=dev)))
                for lanes in builds:
                    a, nu, eu = kernels.grouped_act(q, mask_ab.T, act_key, eps_key, eps,
                                                    return_uniforms=True, lanes=lanes)
                    what = f"B={B} q={scale} eps={eps} lanes={lanes}"
                    diff("grouped_act", a, want, f"{what} actions")
                    diff("grouped_act", nu, want_nu, f"{what} noise uniforms")
                    diff("grouped_act", eu, want_eu, f"{what} draw uniforms")
            for lanes in builds:
                diff("grouped_act", kernels.grouped_act(q, mask_ab.T, fill=float("-inf"), lanes=lanes),
                     act_plain(q, mask_ab.T, fill=float("-inf")), f"B={B} greedy lanes={lanes}")
        act_runs.append({"B": B, "q_scales": 3, "epsilons": 3, "builds": len(builds)})

    spans = (1, 7, 1000, 65536, 65537, 130_048, 2**31 - 1)
    store = {"x": torch.zeros((8,), dtype=torch.int32, device=dev)}
    for span in spans:
        for n in (4096, 4093):
            key = threefry.fold_in(threefry.prng_key(13), span % 1000 + n)
            _, _, off = kernels.replay_sample(store, key, n, span, return_offsets=True)
            diff("replay_sample", off.long(), threefry.randint_lanes(key, n, span, dev),
                 f"randint span={span} n={n}")
            if not np.array_equal(off.cpu().numpy(), threefry.randint(key, n, span)):
                raise AssertionError(f"randint span={span} n={n}: card and host draws differ")
    torch.cuda.synchronize()
    emit({"phase": "grouped_act_randint", "actions_equal": True, "uniforms_bit_equal": True,
          "act_runs": act_runs, "randint_spans": list(spans), "randint_equal": True,
          "seconds": time.perf_counter() - t0})


def _replay_block(B, obs_shape, g, dev):
    A = 40
    return {"obs": torch.randn((B,) + obs_shape, generator=g, device=dev),
            "mask": (torch.rand((A, B), generator=g, device=dev) < 0.5).float().T,
            "action": torch.randint(0, A, (B,), generator=g, device=dev, dtype=torch.int32),
            "reward": torch.randn((B,), generator=g, device=dev),
            "done": torch.rand((B,), generator=g, device=dev) < 0.05}


def add_library_ms(data, block, pos, reps) -> float:
    """Device ms of ``replay_add``'s library time: one PyTorch call that
    writes the obs field alone (``store.narrow(0, pos, B).copy_(obs)``, the
    largest field's write; the port never calls it)."""
    dst = data["obs"].narrow(0, pos, block["obs"].shape[0])
    return device_ms(lambda: dst.copy_(block["obs"]), reps)


REPLAY_EDGE_N = (1, 3, 256, 512, 65536)  # replay_sample: edge counts and the DQN paths' 256 and 512


def replay_sample_edges_diff(kbuf, pbuf, batch, seed, what) -> int:
    """``replay_sample`` on ``kbuf`` against its plain twins on ``pbuf`` (the
    same stores) at ``REPLAY_EDGE_N`` samples, with successors (``batch``
    entries on) and without, its offsets against the host's randint; returns
    the launches compared."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import buffers

    start, n_valid = buffers._successor_window(kbuf, batch)
    span = max(kbuf.size, 1)
    for n in REPLAY_EDGE_N:
        key = threefry.fold_in(threefry.prng_key(seed), n)
        kc, kn, off = kernels.replay_sample(kbuf.data, key, n, n_valid, start=start, batch=batch,
                                            return_offsets=True)
        ks, _, soff = kernels.replay_sample(kbuf.data, key, n, span, return_offsets=True)
        pc, pn = buffers.sample_with_next_plain(pbuf, key, n, batch)
        ps = buffers.sample_plain(pbuf, key, n)
        if not (np.array_equal(off.cpu().numpy(), threefry.randint(key, n, n_valid))
                and np.array_equal(soff.cpu().numpy(), threefry.randint(key, n, span))):
            raise AssertionError(f"{what} n={n}: replay_sample's offsets differ from the host's randint")
        for k in kbuf.data:
            diff("replay_sample", kc[k], pc[k], f"{what} n={n} sample {k}")
            diff("replay_sample", kn[k], pn[k], f"{what} n={n} successor {k}")
            diff("replay_sample", ks[k], ps[k], f"{what} n={n} without successors {k}")
    return 2 * len(REPLAY_EDGE_N)


def check_replay(dev) -> None:
    """Phase 13: ``replay_add`` and ``replay_sample`` against their plain versions
    across the buffer's wrap-around, and ``replay_sample`` at the edge counts
    of ``REPLAY_EDGE_N`` on each last buffer."""
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import buffers

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    t0 = time.perf_counter()
    runs = []
    for B, blocks, obs_shape in ((1024, 8, (40, 13)), (64, 4, (40, 20, 10)), (1000, 3, (40, 13))):
        example = _replay_block(B, obs_shape, g, dev)
        kbuf = buffers.create(example, blocks * B, B)
        pbuf = buffers.create(example, blocks * B, B)
        for t in range(blocks + 4):  # wraps after `blocks` adds
            block = _replay_block(B, obs_shape, g, dev)
            kbuf = buffers.add(kbuf, block)
            pbuf = buffers.add_plain(pbuf, block)
            for k in example:
                diff("replay_add", kbuf.data[k], pbuf.data[k], f"B={B} add {t} {k}")
            if t:
                key = threefry.fold_in(threefry.prng_key(31), t)
                kc, kn = buffers.sample_with_next(kbuf, key, 256, B)
                pc, pn = buffers.sample_with_next_plain(pbuf, key, 256, B)
                ks, ps = buffers.sample(kbuf, key, 255), buffers.sample_plain(pbuf, key, 255)
                for k in example:
                    diff("replay_sample", kc[k], pc[k], f"B={B} sample {t} {k}")
                    diff("replay_sample", kn[k], pn[k], f"B={B} successor {t} {k}")
                    diff("replay_sample", ks[k], ps[k], f"B={B} plain sample {t} {k}")
        edges = replay_sample_edges_diff(kbuf, pbuf, B, 130 + B, f"phase 13 B={B}")
        runs.append({"B": B, "capacity": blocks * B, "obs": list(obs_shape), "adds": blocks + 4,
                     "edge_launches": edges})
    torch.cuda.synchronize()
    emit({"phase": "replay", "bit_equal": True, "runs": runs, "edge_samples": list(REPLAY_EDGE_N),
          "seconds": time.perf_counter() - t0})


def check_small_grouped() -> None:
    """Phase 14: a small fp32 grouped DQN on the card against the same run on
    the CPU, then a 64-episode evaluation of its weights on both."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.models.init import init_lecun_
    from tetris_gymnasium_torch.models.networks import QMLP
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import grouped_dqn
    from tetris_gymnasium_torch.rl.evaluate import evaluate_grouped, greedy_masked_q

    t0 = time.perf_counter()
    env_config = EngineConfig(gravity_enabled=False, auto_reset=True)
    cfg = grouped_dqn.GroupedDQNConfig(**SMALL_GROUPED_CFG)
    start = to_flax_params(init_lecun_(QMLP(), torch.Generator().manual_seed(5)).state_dict(), "qmlp")
    runs = {}
    with deterministic_cudnn():
        for where in ("cuda", "cpu"):
            ts = grouped_dqn.init_grouped_dqn_state(prng_key(3), 64, env_config, cfg, device=where,
                                                    params=start)
            step = grouped_dqn.make_train_step(env_config, cfg)
            losses = []
            for _ in range(SMALL_GROUPED_STEPS):
                ts, m = step(ts)
                losses.append(float(m["loss"]))
            runs[where] = (ts, losses)
    (tc, lc), (tp, lp) = runs["cuda"], runs["cpu"]
    for k, v in tc.buffer.data.items():
        if not torch.equal(bits(v.cpu()), bits(tp.buffer.data[k])):
            raise AssertionError(f"small grouped DQN: replay {k} differs between card and CPU")
    for k in turbo.FIELDS:
        if not torch.equal(bits(getattr(tc.env_states.env, k).cpu()), bits(getattr(tp.env_states.env, k))):
            raise AssertionError(f"small grouped DQN: env {k} differs between card and CPU")
    pc, pp = to_flax_params(tc.net.state_dict(), "qmlp"), to_flax_params(tp.net.state_dict(), "qmlp")
    norm_worst, elem_worst = param_change_diff("small grouped DQN", start, pc, pp,
                                               SMALL_GROUPED_PARAM_TOL)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lc, lp))
    stats = {}
    for where, net in (("cuda", tc.net), ("cpu", copy.deepcopy(tc.net).cpu())):
        stats[where] = evaluate_grouped(greedy_masked_q(net), 64, EngineConfig(gravity_enabled=False),
                                        prng_key(7), max_steps=512, device=where)
    for k, v in stats["cuda"].items():
        if v != stats["cpu"][k]:
            raise AssertionError(f"small grouped evaluation: {k} {v} on the card, "
                                 f"{stats['cpu'][k]} on the CPU")
    emit({"phase": "small_grouped", "replay_bit_equal": True, "env_bit_equal": True,
          "steps": SMALL_GROUPED_STEPS, "param_change_max_norm_rel_diff": norm_worst,
          "param_change_max_elem_rel_diff": elem_worst,
          "loss_max_rel_diff": loss_rel, "loss_last": [lc[-1], lp[-1]],
          "eval_equal": stats["cuda"], "seconds": time.perf_counter() - t0})


def train_grouped_full_width(dev, smi) -> dict:
    """Phase 15: ``examples/train_lin_grouped.py`` at the committed run's shape."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.examples import train_lin_grouped
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl.evaluate import evaluate_grouped, greedy_masked_q
    from tetris_gymnasium_torch.utils.checkpoint import load_flat, load_q_net

    args = train_lin_grouped.parse_args(GROUPED_ARGV)
    events = []  # one dict of CUDA events per train step

    def mark(name):
        if name == "start":
            events.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1][name] = ev

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, records = train_lin_grouped.train(args, marks=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = GROUPED_STEPS
    learn = n - GROUPED_LEARNING_STARTS
    want = {**{k: 0 for k in launches}, "grouped_act": n, "turbo_step": n, "turbo_init": n + 1,
            "grouped_placements": n + 1, "replay_add": n, "replay_sample": learn}
    if launches != want:
        raise AssertionError(f"grouped training launch counts {launches}, want {want}")
    for rec in records:
        for k, v in rec.items():
            if not np.isfinite(v):
                raise AssertionError(f"grouped training metric {k} is not finite: {rec}")
    start = load_flat(GROUPED_INIT)
    untrained = load_q_net(GROUPED_INIT, "qmlp", device=dev)
    trained = to_flax_params(ts.net.state_dict(), "qmlp")
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in start}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"some parameters did not move: {moved}")
    chunk_lines = [r["lines"] for r in records]
    first, last = sum(chunk_lines[:3]) / 3, sum(chunk_lines[-3:]) / 3
    if not last > 3 * max(first, 1.0):
        raise AssertionError(f"no learning: {first} -> {last} lines per chunk ({chunk_lines})")

    split = {"before_learning": split_ms(events[10:GROUPED_LEARNING_STARTS]),
             "learning": split_ms(events[GROUPED_LEARNING_STARTS + 10 :])}
    emit({"phase": "grouped_train", "n_envs": GROUPED_ENVS, "steps": n, "wall_s_with_setup": wall,
          "launches": launches, "lines_per_chunk": chunk_lines,
          "lines_per_step": [r["lines_per_step"] for r in records],
          "first3_mean": first, "last3_mean": last, "records_last": records[-1],
          "step_split_ms": split, "env_steps_per_s_learning": GROUPED_ENVS / (split["learning"]["step"] * 1e-3),
          "param_max_change": moved, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    evals = {}
    for name, net in (("untrained", untrained), ("trained", ts.net)):
        evals[name] = evaluate_grouped(greedy_masked_q(net), GROUPED_EVAL_EPISODES,
                                       EngineConfig(gravity_enabled=False), prng_key(EVAL_SEED),
                                       max_steps=GROUPED_EVAL_MAX_STEPS, device=dev)
    emit({"phase": "grouped_eval", "episodes": GROUPED_EVAL_EPISODES,
          "max_steps": GROUPED_EVAL_MAX_STEPS, **evals, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    # the card's busy share: 20 more learning steps under torch.profiler
    from tetris_gymnasium_torch.rl import grouped_dqn

    cfg = grouped_dqn.GroupedDQNConfig(exploration_steps=args.exploration_steps,
                                       learning_starts=args.learning_starts)
    step = grouped_dqn.make_train_step(EngineConfig(gravity_enabled=False, auto_reset=True), cfg)
    ts, busy = profile_steps(step, ts)
    emit({"phase": "grouped_profile", **busy, "nvidia_smi": smi})
    check_grouped_path_shapes(dev, ts, cfg)
    return {"launches": launches, "split": split}


def check_grouped_path_shapes(dev, ts, cfg) -> None:
    """The end of phase 15: the kernels against their plain versions at the
    shapes the grouped training path gives them, on its trained state."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import buffers

    t0 = time.perf_counter()
    env_config = EngineConfig(gravity_enabled=False, auto_reset=True)
    gs = ts.env_states
    for mode, plain in (("features", tg.placements_plain), ("boards", tg.placement_boards_plain)):
        got = kernels.grouped_placements(gs.env, env_config, turbo.PIECES, 4, mode)
        for a, b, name in zip(got, plain(gs.env, env_config), ("obs", "mask", "game_over", "lines")):
            diff("grouped_placements", a, b, f"trained state {mode} {name}")

    # one grouped step on the card and on a CPU copy; one action in ten is
    # uniform over all candidates, so some pieces teleport into the bedrock
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    a = _grouped_actions(gs, g, dev)
    n_illegal = int((gs.mask.gather(0, a.long()[None])[0] == 0).sum())
    if n_illegal == 0:
        raise AssertionError("the grouped step check drew no illegal action")
    on_cpu = tg.TurboGroupedState(
        env=gs.env.replace(**{k: getattr(gs.env, k).cpu() for k in turbo.FIELDS}), mask=gs.mask.cpu())
    kgs, kobs, kr, kd, kinfo = tg.step(gs, a, env_config)
    pgs, pobs, pr, pd, pinfo = tg.step(on_cpu, a.cpu(), env_config)
    for k in turbo.FIELDS:
        diff("turbo_step", getattr(kgs.env, k).cpu(), getattr(pgs.env, k), f"trained step {k}")
    diff("turbo_step", kr.cpu(), pr, "trained step reward")
    diff("turbo_step", kd.cpu(), pd, "trained step done")
    diff("turbo_step", kinfo["lines_cleared"].cpu(), pinfo["lines_cleared"], "trained step lines")
    diff("grouped_placements", kgs.mask.cpu(), pgs.mask, "trained step mask")
    diff("grouped_placements", kobs.cpu(), pobs, "trained step obs")

    # that step's transition into copies of the full buffer, then a sample
    buf = ts.buffer
    if buf.size != buf.capacity or buf.pos == 0:
        raise AssertionError(f"the buffer is not full and wrapped: pos {buf.pos}, size {buf.size}")
    block = {"obs": ts.obs, "mask": gs.mask.T, "action": a, "reward": kr, "done": kd}
    kbuf, pbuf = (buffers.ReplayBuffer({k: v.clone() for k, v in buf.data.items()}, buf.pos, buf.size)
                  for _ in range(2))
    kbuf, pbuf = buffers.add(kbuf, block), buffers.add_plain(pbuf, block)
    for k in buf.data:
        diff("replay_add", kbuf.data[k], pbuf.data[k], f"full buffer add {k}")
    key = threefry.fold_in(threefry.prng_key(17), ts.step)
    kc, kn = buffers.sample_with_next(kbuf, key, cfg.batch_size, GROUPED_ENVS)
    pc, pn = buffers.sample_with_next_plain(pbuf, key, cfg.batch_size, GROUPED_ENVS)
    for k in buf.data:
        diff("replay_sample", kc[k], pc[k], f"full buffer sample {k}")
        diff("replay_sample", kn[k], pn[k], f"full buffer successor {k}")
    replay_sample_edges_diff(kbuf, pbuf, GROUPED_ENVS, 150, "phase 15 full buffer")
    torch.cuda.synchronize()
    emit({"phase": "grouped_path_shapes", "bit_equal": True, "B": GROUPED_ENVS,
          "illegal_actions": n_illegal, "buffer_capacity": buf.capacity, "buffer_pos": buf.pos,
          "samples": cfg.batch_size, "seconds": time.perf_counter() - t0})


def _bound(io_bytes, ops):
    bytes_ms, ops_ms = 1e3 * io_bytes / HBM_BYTES_PER_S, 1e3 * ops / OPS_PER_S
    return {"bytes": io_bytes, "operations": ops, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def placement_ops(cfg, mode) -> int:
    """32-bit operations of one candidate in the one-thread-a-candidate
    design of ``grouped_placements`` (each thread with its env's rows: 8 per
    hit-map window, 6 per full-row test, 20 per row of the compaction and
    counters or 2 per cell of a board, 18 per column of the counter
    read-out, 40 of geometry and legality), kept beside the bound that
    :func:`grouped_placements_ops` counts."""
    H = cfg.padded_height
    per_row = 20 if mode == "features" else 2 * cfg.width
    tail = 18 * cfg.width if mode == "features" else 0
    return 8 * (H - 3) + 6 * cfg.height + per_row * cfg.height + tail + 40


def grouped_placements_ops(cfg, P, mode, lines) -> int:
    """32-bit operations of one ``grouped_placements`` launch at ``cfg`` in
    ``mode``, by the kernel's own count (csrc/grouped_placements.cu), for
    the candidates whose ``lines`` (int32[A, B], the launch's own) it got:
    an env's shared pass once over its A candidates (4 a padded cell for
    the column masks and tops, 2 a playfield cell for its top, count and
    bumpiness term, 3 a row word for fullness), then a candidate's drop from
    the column tops (4 a piece cell), its S window rows (6 and 4 a word:
    frame, stack, lock, fullness) and 30 of setup and outputs; in features
    mode the S columns under the window patched (3 + 2 S each), S + 1
    bumpiness pairs (8 each) and the W heights copied (2 each), or for each
    candidate that clears rows (this launch's data) the block's column pass,
    a column's height twice (its own and its left neighbour's for the
    bumpiness: 3 a piece row and 20 each); in boards mode 2.5
    an output cell (its byte built in shared memory, then 4 bytes read as a
    word, converted and stored) and 8 a row."""
    H, PW, W, h, S = cfg.padded_height, cfg.padded_width, cfg.width, cfg.height, _side(P)
    nw, nwf = (PW + 31) // 32, (W + 31) // 32
    n_cand, n_clear = lines.numel(), int((lines > 0).sum())
    shared = (4 * H * PW + 2 * h * W + 3 * h * nw) // (4 * W)
    base = shared + 4 * S * S + S * (6 + 4 * nw) + 30
    if mode != "features":
        return n_cand * (base + 5 * h * W // 2 + 8 * h * nwf)
    patch = S * (3 + 2 * S) + 8 * (S + 1) + 2 * W
    return n_cand * base + (n_cand - n_clear) * patch + n_clear * 2 * W * (3 * S + 20)


def time_grouped_kernels(dev, smi) -> dict:
    """Phase 16: the grouped kernels' device times beside their bounds, and
    the engine's placements per second."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.rl import buffers, grouped_dqn

    g = torch.Generator(device=dev)
    g.manual_seed(16)
    cfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    A = cfg.width * 4
    out = {"grouped_placements": {}, "grouped_act": {}, "replay_add": {}, "replay_sample": {},
           "grouped_step": {}}

    for B in GROUPED_TIME_B:
        gs, _ = tg.reset(batch_keys(prng_key(1), B, device=dev), cfg, device=dev)
        for _ in range(20):  # mid-game boards
            gs = tg.step(gs, _grouped_actions(gs, g, dev, wild=0.0), cfg)[0]
        s = gs.env
        big = B >= 65536
        if B == GROUPED_ENVS:  # the step's re-initialisation, from the state's [2, B] key as it lies
            _fields_diff("turbo_init", turbo.init_from_key(s.key, cfg), turbo.init_plain(s.key.T, cfg),
                         turbo.FIELDS, "phase 16 init_from_key")
            out["turbo_init"] = timed_pair(
                lambda: turbo.init_from_key(s.key, cfg), lambda: turbo.init_plain(s.key.T, cfg), 100, 10,
                nbytes(s.key) + nbytes(*(getattr(s, k) for k in turbo.FIELDS)), 0)
            out["turbo_init"].update(library_ms=None, shape=kernels.turbo_init_shape(cfg, turbo.PIECES, B))
        lines = kernels.grouped_placements(s, cfg, turbo.PIECES)[3]
        for mode in ("features", "boards"):
            obs_bytes = B * A * (cfg.width + 3 if mode == "features" else cfg.height * cfg.width) * 4
            io = nbytes(s.rows, s.piece, s.rotation) + obs_bytes + B * A * (4 + 1 + 4)
            plain = tg.placements_plain if mode == "features" else tg.placement_boards_plain
            entry = out["grouped_placements"][f"{mode}@{B}"] = timed_pair(
                lambda: kernels.grouped_placements(s, cfg, turbo.PIECES, 4, mode),
                lambda: plain(s, cfg), 20 if big else 100, 1 if big else 3, io,
                grouped_placements_ops(cfg, turbo.PIECES, mode, lines))
            # the bound by the one-thread-a-candidate design's count, kept
            # beside the restated one
            entry["bound_ms_thread_per_candidate"] = _bound(io, B * A * placement_ops(cfg, mode))["bound_ms"]
            entry["clearing_candidates"] = int((lines > 0).sum())
            a = _grouped_actions(gs, g, dev, wild=0.0)
            mode_gs = tg.TurboGroupedState(env=s, mask=gs.mask)
            step_ms = device_ms(lambda: tg.step(mode_gs, a, cfg, mode=mode), 5 if big else 20)
            out["grouped_step"][f"{mode}@{B}"] = {
                "ms": step_ms, "call_ms": call_ms(lambda: tg.step(mode_gs, a, cfg, mode=mode), 20),
                "placements_per_s": B * A / (step_ms * 1e-3),
                "kernel_placements_per_s": B * A / (out["grouped_placements"][f"{mode}@{B}"]["ms"] * 1e-3),
            }
        emit({"phase": "grouped_times", "B": B, "grouped_placements": {
            k: v for k, v in out["grouped_placements"].items() if k.endswith(f"@{B}")},
            "grouped_step": {k: v for k, v in out["grouped_step"].items() if k.endswith(f"@{B}")},
            "nvidia_smi": smi})

    for B in (GROUPED_ENVS, 4096):
        q = torch.randn((B, A), generator=g, device=dev)
        mask = (torch.rand((A, B), generator=g, device=dev) < 0.5).float().T
        act_key, eps_key = threefry.split(prng_key(B))
        io = nbytes(q) + B * A * 4 + B * 4
        ops = B * (A * ACT_OPS_PER_CANDIDATE + ACT_OPS_PER_ENV)
        out["grouped_act"][B] = timed_pair(
            lambda: kernels.grouped_act(q, mask, act_key, eps_key, 0.3),
            lambda: grouped_dqn.act_plain(q, mask, act_key, eps_key, 0.3), 100, 10, io, ops)
        # each lane width at the path's shapes, held to the plain version first
        want = grouped_dqn.act_plain(q, mask, act_key, eps_key, 0.3)
        lanes_ms = {}
        for L in kernels.GROUPED_ACT_LANES:
            diff("grouped_act", kernels.grouped_act(q, mask, act_key, eps_key, 0.3, lanes=L), want,
                 f"phase 16 B={B} lanes={L}")
            lanes_ms[f"lanes{L}"] = device_ms(lambda: kernels.grouped_act(q, mask, act_key, eps_key, 0.3,
                                                                          lanes=L), 100)
        out["grouped_act"][B]["builds_ms"] = lanes_ms
        out["grouped_act"][B]["lanes"] = kernels.grouped_act_lanes(B)
        # the greedy launch (the evaluation's), beside torch.where + argmax
        # (two calls: a yardstick, not a library time)
        fill = float("-inf")
        diff("grouped_act", kernels.grouped_act(q, mask, fill=fill),
             grouped_dqn.act_plain(q, mask, fill=fill), f"phase 16 B={B} greedy")
        out["grouped_act"][B]["greedy_ms"] = device_ms(lambda: kernels.grouped_act(q, mask, fill=fill), 100)
        out["grouped_act"][B]["where_argmax_ms"] = device_ms(
            lambda: torch.where(mask > 0, q, fill).argmax(-1), 100)

    # the replay at the committed run's shape: 1024 envs, 131,072 entries
    B = GROUPED_ENVS
    example = _replay_block(B, (A, cfg.width + 3), g, dev)
    buf = buffers.create(example, grouped_dqn.GroupedDQNConfig().buffer_size, B)
    for _ in range(buf.capacity // B):
        buf = buffers.add(buf, _replay_block(B, (A, cfg.width + 3), g, dev))
    block = _replay_block(B, (A, cfg.width + 3), g, dev)
    entry = sum(x[0].numel() * x.element_size() for x in buf.data.values())
    out["replay_add"][B] = timed_pair(lambda: buffers.add(buf, block), lambda: buffers.add_plain(buf, block),
                                 100, 20, 2 * B * entry, 0)
    out["replay_add"][B]["library_ms"] = add_library_ms(buf.data, block, buf.pos, 100)
    key = prng_key(3)
    out["replay_sample"][256] = timed_pair(
        lambda: buffers.sample_with_next(buf, key, 256, B),
        lambda: buffers.sample_with_next_plain(buf, key, 256, B), 100, 20, 4 * 256 * entry,
        2 * 256 * SAMPLE_INDEX_OPS)
    out["replay_sample"][256]["shape"] = kernels.replay_sample_shape(buf.data, 256, B)
    emit({"phase": "grouped_times", "grouped_act": out["grouped_act"], "replay_add": out["replay_add"],
          "replay_sample": out["replay_sample"], "turbo_init_from_key": out["turbo_init"],
          "buffer_capacity": buf.capacity,
          "buffer_mib": sum(nbytes(x) for x in buf.data.values()) / 2**20, "nvidia_smi": smi})
    return out


# ---------------------------------------------------------------------------
# 17.-20. the CNN DQN slice
# ---------------------------------------------------------------------------


def stacked_builds(data, k, obs_key="obs") -> list:
    """The builds of ``replay_sample_stacked`` that the obs store takes:
    both where its frames fit the bulk copies (``kernels.replay_stacked_build``),
    else the words build."""
    from tetris_gymnasium_torch import kernels

    store = data[obs_key]
    row = store[0].numel() * store.element_size()
    return [b for b in kernels.REPLAY_STACKED_BUILDS
            if b == "words" or kernels.replay_stacked_build(row, k, store) == "bulk"]


def stacked_builds_diff(buf, key, n, B, K, want, what) -> None:
    """Every build of ``replay_sample_stacked`` that the buffer takes, bit-equal to ``want``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.rl import buffers

    start, n_valid = buffers._stacked_window(buf, B, K)
    for b in stacked_builds(buf.data, K):
        kc, kn = kernels.replay_sample_stacked(buf.data, key, n, n_valid, start, B, K, build=b)
        for k in buf.data:
            diff("replay_sample_stacked", kc[k], want[0][k], f"{what} ({b}) sample {k}")
            diff("replay_sample_stacked", kn[k], want[1][k], f"{what} ({b}) successor {k}")


def _dqn_block(B, window, g, dev):
    """One transition batch whose stored frame is the window's newest, a strided view."""
    return {"obs": window[:, -1],
            "action": torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32),
            "reward": torch.randn((B,), generator=g, device=dev),
            "done": torch.rand((B,), generator=g, device=dev) < 0.15}


def _boards(shape, g, dev):
    return torch.randint(-1, 2, shape, generator=g, device=dev, dtype=torch.int8)


def check_dqn_kernels(dev) -> None:
    """Phase 17: ``framestack_push``, ``replay_sample_stacked`` (with
    ``replay_add`` from a strided view) and ``dqn_act`` against their plain
    versions, and the draws against JAX's mapping."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import framestack, threefry
    from tetris_gymnasium_torch.rl import buffers, dqn

    g = torch.Generator(device=dev)
    g.manual_seed(17)
    t0 = time.perf_counter()
    push_runs = []
    for B, K in ((1024, 4), (512, 4), (1, 2), (1001, 2)):
        stack = _boards((B, K, 20, 10), g, dev)
        n_done = 0
        for t in range(8):
            obs = _boards((B, 20, 10), g, dev)
            done = torch.rand((B,), generator=g, device=dev) < 0.15
            got = kernels.framestack_push(stack, obs, done)
            diff("framestack_push", got, framestack.push_plain(stack, obs, done), f"B={B} K={K} push {t}")
            n_done += int(done.sum())
            stack = got
        push_runs.append({"B": B, "K": K, "pushes": 8, "dones": n_done})

    sample_runs = []
    for B, blocks, K, n in ((1024, 8, 4, 512), (64, 12, 4, 1001), (100, 7, 2, 256)):
        window = _boards((B, K, 20, 10), g, dev)
        example = _dqn_block(B, window, g, dev)
        kbuf, pbuf = (buffers.create(example, blocks * B, B) for _ in range(2))
        samples = 0
        for t in range(2 * blocks + 3):  # wraps twice
            block = _dqn_block(B, window, g, dev)
            kbuf, pbuf = buffers.add(kbuf, block), buffers.add_plain(pbuf, block)
            for k in example:
                diff("replay_add", kbuf.data[k], pbuf.data[k], f"B={B} strided add {t} {k}")
            window = framestack.push(window, _boards((B, 20, 10), g, dev), block["done"])
            if t < K:  # k + 1 blocks must be resident
                continue
            key = threefry.fold_in(threefry.prng_key(41), t)
            start, n_valid = buffers._stacked_window(kbuf, B, K)
            kc, kn, off = kernels.replay_sample_stacked(kbuf.data, key, n, n_valid, start, B, K,
                                                         return_offsets=True)
            pc, pn = buffers.sample_with_next_stacked_plain(pbuf, key, n, B, K)
            for k in example:
                diff("replay_sample_stacked", kc[k], pc[k], f"B={B} K={K} sample {t} {k}")
                diff("replay_sample_stacked", kn[k], pn[k], f"B={B} K={K} successor {t} {k}")
            stacked_builds_diff(kbuf, key, n, B, K, (pc, pn), f"B={B} K={K} {t}")
            diff("replay_sample_stacked", off.long(), threefry.randint_lanes(key, n, n_valid, dev),
                 f"B={B} K={K} offsets {t}")
            if not np.array_equal(off.cpu().numpy(), threefry.randint(key, n, n_valid)):
                raise AssertionError(f"stacked sample offsets B={B} t={t}: card and host draws differ")
            samples += 1
        sample_runs.append({"B": B, "capacity": blocks * B, "K": K, "n": n, "samples": samples})

    act_runs = []
    for B in (1024, 1, 1001):
        counters = torch.arange(B, dtype=torch.int64, device=dev)
        for trial, scale in enumerate(("near-ties", 1.0, 30.0)):
            if scale == "near-ties":  # many Q values equal, the rest 2**-20 apart
                q = torch.randint(0, 3, (B, 8), generator=g, device=dev).float() * 2**-20
            else:
                q = torch.randn((B, 8), generator=g, device=dev) * scale
            for eps in (0.0, 0.3, 1.0):
                act_key, eps_key = threefry.split(threefry.fold_in(threefry.prng_key(B), trial))
                a, ra, eu = kernels.dqn_act(q, act_key, eps_key, eps, return_draws=True)
                what = f"B={B} q={scale} eps={eps}"
                diff("dqn_act", a, dqn.act_plain(q, act_key, eps_key, eps), f"{what} actions")
                diff("dqn_act", ra, threefry.randint_lanes(act_key, B, 8, dev).to(torch.int32),
                     f"{what} randint")
                if not np.array_equal(ra.cpu().numpy(), threefry.randint(act_key, B, 8)):
                    raise AssertionError(f"{what}: card and host randint draws differ")
                diff("dqn_act", eu, threefry.bits_to_uniform_lanes(
                    threefry.random_bits32_lanes(eps_key, counters)), f"{what} uniforms")
            diff("dqn_act", kernels.dqn_act(q), dqn.act_plain(q), f"B={B} q={scale} greedy")
        act_runs.append({"B": B, "q_scales": 3, "epsilons": 3})
    torch.cuda.synchronize()
    emit({"phase": "dqn_kernels", "bit_equal": True, "push_runs": push_runs,
          "sample_runs": sample_runs, "act_runs": act_runs,
          "max_abs_err": {k: MAX_ERR[k] for k in ("framestack_push", "replay_sample_stacked",
                                                  "dqn_act", "replay_add")},
          "seconds": time.perf_counter() - t0})


def check_small_dqn() -> None:
    """Phase 18: a small fp32 K = 4 DQN on the card against the same run on the CPU."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.models.networks import QNetworkCNN
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import dqn
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    env_config = EngineConfig(auto_reset=True)
    cfg = dqn.DQNConfig(**SMALL_DQN_CFG)
    start = load_flat(DQN_INIT[4])
    runs = {}
    with deterministic_cudnn():
        for where in ("cuda", "cpu"):
            ts = dqn.init_dqn_state(prng_key(3), 64, env_config, cfg,
                                    net=QNetworkCNN(in_channels=4, dtype=torch.float32),
                                    device=where, params=start)
            step = dqn.make_train_step(env_config, cfg)
            losses, dones = [], 0
            for _ in range(SMALL_DQN_STEPS):
                ts, m = step(ts)
                losses.append(float(m["loss"]))
                dones += int(m["episodes_done"])
            runs[where] = (ts, losses, dones)
    (tc, lc, dc), (tp, lp, _) = runs["cuda"], runs["cpu"]
    for k, v in tc.buffer.data.items():
        if not torch.equal(bits(v.cpu()), bits(tp.buffer.data[k])):
            raise AssertionError(f"small DQN: replay {k} differs between card and CPU")
    for k in turbo.FIELDS:
        if not torch.equal(bits(getattr(tc.env_states, k).cpu()), bits(getattr(tp.env_states, k))):
            raise AssertionError(f"small DQN: env {k} differs between card and CPU")
    if not torch.equal(tc.obs.cpu(), tp.obs):
        raise AssertionError("small DQN: the window differs between card and CPU")
    pc, pp = to_flax_params(tc.net.state_dict(), "q_cnn"), to_flax_params(tp.net.state_dict(), "q_cnn")
    norm_worst, elem_worst = param_change_diff("small DQN", start, pc, pp, SMALL_DQN_PARAM_TOL)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lc, lp))
    emit({"phase": "small_dqn", "replay_bit_equal": True, "env_bit_equal": True,
          "window_bit_equal": True, "steps": SMALL_DQN_STEPS, "episodes_done": dc,
          "param_change_max_norm_rel_diff": norm_worst,
          "param_change_max_elem_rel_diff": elem_worst, "loss_max_rel_diff": loss_rel,
          "loss_last": [lc[-1], lp[-1]], "seconds": time.perf_counter() - t0})


def dqn_argv(K) -> list:
    return ["--n-envs", str(DQN_ENVS), "--steps", str(DQN_STEPS), "--chunk", str(DQN_CHUNK),
            "--exploration-steps", str(DQN_EXPLORATION), "--learning-starts", str(DQN_LEARNING_STARTS),
            "--seed", "1", "--frame-stack", str(K), "--init-params", DQN_INIT[K]]


def train_dqn_full_width(dev, smi, K) -> dict:
    """Phase 19: ``examples/train_cnn.py`` at the committed runs' shape, frame stack ``K``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.examples import train_cnn
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.rl import dqn
    from tetris_gymnasium_torch.rl.evaluate import evaluate_q_checkpoint
    from tetris_gymnasium_torch.utils.checkpoint import load_flat, load_q_net

    args = train_cnn.parse_args(dqn_argv(K))
    events = []  # one dict of CUDA events per train step

    def mark(name):
        if name == "start":
            events.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1][name] = ev

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, records = train_cnn.train(args, marks=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n, learn = DQN_STEPS, DQN_STEPS - DQN_LEARNING_STARTS
    want = {**{k: 0 for k in launches}, "turbo_init": 1, "turbo_step": n, "turbo_step_obs": n,
            "observe_board": 1, "dqn_act": n, "replay_add": n}
    want.update({"replay_sample": learn} if K == 1 else
                {"replay_sample_stacked": learn, "framestack_push": n})
    if launches != want:
        raise AssertionError(f"DQN K={K} launch counts {launches}, want {want}")
    for rec in records:
        for k, v in rec.items():
            if not np.isfinite(v):
                raise AssertionError(f"DQN K={K} metric {k} is not finite: {rec}")
    start = load_flat(DQN_INIT[K])
    trained = to_flax_params(ts.net.state_dict(), "q_cnn")
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in start}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"some parameters did not move: {moved}")
    chunks = [r["reward_per_step"] for r in records]
    with open(DQN_JAX_CURVE[K]) as f:
        jax_chunks = [json.loads(line)["reward_per_step"] for line in f][: len(chunks)]
    first = sum(chunks[:2]) / 2  # steps 1-500
    ratio = chunks[-1] / first  # steps 1751-2000
    jax_ratio = jax_chunks[-1] / (sum(jax_chunks[:2]) / 2)

    split = {"before_learning": split_ms(events[10:DQN_LEARNING_STARTS]),
             "learning": split_ms(events[DQN_LEARNING_STARTS + 10:])}
    emit({"phase": "dqn_train", "frame_stack": K, "n_envs": DQN_ENVS, "steps": n,
          "wall_s_with_setup": wall, "launches": launches,
          "reward_per_step_chunks": chunks, "jax_reward_per_step_chunks": jax_chunks,
          "steps_per_episode_chunks": [r["steps_per_episode"] for r in records],
          "gate_ratio": ratio, "jax_gate_ratio": jax_ratio, "gate": DQN_GATE,
          "records_last": records[-1], "step_split_ms": split,
          "env_steps_per_s_learning": DQN_ENVS / (split["learning"]["step"] * 1e-3),
          "param_max_change": moved, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "nvidia_smi": smi})
    if not ratio >= DQN_GATE:
        raise AssertionError(f"DQN K={K} learning gate: steps 1751-2000 give {chunks[-1]} reward "
                             f"per step, {ratio:.3f}x steps 1-500 ({first}); want {DQN_GATE}x")

    t0 = time.perf_counter()
    evals = {}
    for name, net in (("untrained", load_q_net(DQN_INIT[K], "q_cnn", device=dev)), ("trained", ts.net)):
        kernels.reset_launches()
        evals[name] = evaluate_q_checkpoint(net, EVAL_EPISODES, EngineConfig(), seed=EVAL_SEED,
                                            max_steps=EVAL_MAX_STEPS, frame_stack=K, device=dev)
        torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)  # the trained net's evaluation
    it = evals["trained"]["iterations"]
    want = {**{k: 0 for k in launches}, "turbo_init": 1, "turbo_step": it, "turbo_step_obs": it,
            "observe_board": 1, "dqn_act": it}
    want.update({} if K == 1 else {"framestack_push": it})
    if eval_launches != want:
        raise AssertionError(f"DQN K={K} evaluation launch counts {eval_launches}, want {want}")
    emit({"phase": "dqn_eval", "frame_stack": K, "episodes": EVAL_EPISODES,
          "max_steps": EVAL_MAX_STEPS, **evals, "launches_trained": eval_launches,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    # the card's busy share: 20 more learning steps under torch.profiler
    cfg = dqn.DQNConfig(exploration_steps=args.exploration_steps,
                        learning_starts=args.learning_starts, frame_stack=K)
    ts, busy = profile_steps(dqn.make_train_step(EngineConfig(auto_reset=True), cfg), ts)
    emit({"phase": "dqn_profile", "frame_stack": K, **busy, "nvidia_smi": smi})
    check_dqn_path_shapes(dev, ts, cfg)
    return {"launches": launches, "eval_launches": eval_launches, "split": split}


def check_dqn_path_shapes(dev, ts, cfg) -> None:
    """The end of phase 19: every kernel of the DQN path against its plain
    version at the path's shapes, on its trained state."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops import framestack, threefry
    from tetris_gymnasium_torch.rl import buffers, dqn

    t0 = time.perf_counter()
    K = cfg.frame_stack
    env_config = EngineConfig(auto_reset=True)
    with torch.no_grad():
        q = ts.net(ts.obs)
    act_key, eps_key = threefry.split(threefry.fold_in(threefry.prng_key(19), ts.step))
    a = kernels.dqn_act(q, act_key, eps_key, 0.5)
    diff("dqn_act", a, dqn.act_plain(q, act_key, eps_key, 0.5), "trained state actions")
    s = ts.env_states
    on_cpu = s.replace(**{k: getattr(s, k).cpu() for k in turbo.FIELDS})
    raw = torch.empty((a.shape[0], env_config.height, env_config.width), dtype=torch.int8,
                      device=dev)
    ks, kr, kd, kl = kernels.turbo_step(s, a, env_config, turbo.PIECES, RewardsMapping(), obs=raw)
    ps, pr, pd, pl = turbo.step_plain(on_cpu, a.cpu(), env_config)
    for k in turbo.FIELDS:
        diff("turbo_step", getattr(ks, k).cpu(), getattr(ps, k), f"trained step {k}")
    for got, want, name in ((kr, pr, "reward"), (kd, pd, "done"), (kl, pl, "lines")):
        diff("turbo_step", got.cpu(), want, f"trained step {name}")
    diff("turbo_step", raw.cpu(), turbo.observe_board_plain(ps, env_config), "trained fused obs")
    diff("observe_board", kernels.observe_board(s, env_config, turbo.PIECES).cpu(),
         turbo.observe_board_plain(on_cpu, env_config), "trained obs")
    n_done = int(kd.sum())
    if K > 1:
        if n_done == 0:
            raise AssertionError("the trained step ended no episode, so no window restarted")
        diff("framestack_push", kernels.framestack_push(ts.obs, raw, kd),
             framestack.push_plain(ts.obs, raw, kd), "trained window push")

    buf = ts.buffer
    if buf.size != buf.capacity or buf.pos == 0:
        raise AssertionError(f"the buffer is not full and wrapped: pos {buf.pos}, size {buf.size}")
    block = {"obs": ts.obs if K == 1 else ts.obs[:, -1], "action": a, "reward": kr, "done": kd}
    kbuf, pbuf = (buffers.ReplayBuffer({k: v.clone() for k, v in buf.data.items()}, buf.pos, buf.size)
                  for _ in range(2))
    kbuf, pbuf = buffers.add(kbuf, block), buffers.add_plain(pbuf, block)
    for k in buf.data:
        diff("replay_add", kbuf.data[k], pbuf.data[k], f"full buffer add {k}")
    key = threefry.fold_in(threefry.prng_key(23), ts.step)
    if K == 1:
        name = "replay_sample"
        (kc, kn), (pc, pn) = (buffers.sample_with_next(kbuf, key, cfg.batch_size, DQN_ENVS),
                              buffers.sample_with_next_plain(pbuf, key, cfg.batch_size, DQN_ENVS))
    else:
        name = "replay_sample_stacked"
        kc, kn = buffers.sample_with_next_stacked(kbuf, key, cfg.batch_size, DQN_ENVS, K)
        pc, pn = buffers.sample_with_next_stacked_plain(pbuf, key, cfg.batch_size, DQN_ENVS, K)
        stacked_builds_diff(kbuf, key, cfg.batch_size, DQN_ENVS, K, (pc, pn), "full buffer")
    for k in buf.data:
        diff(name, kc[k], pc[k], f"full buffer sample {k}")
        diff(name, kn[k], pn[k], f"full buffer successor {k}")
    if K == 1:
        replay_sample_edges_diff(kbuf, pbuf, DQN_ENVS, 190, "phase 19 full buffer")
    torch.cuda.synchronize()
    emit({"phase": "dqn_path_shapes", "frame_stack": K, "bit_equal": True, "B": DQN_ENVS,
          "episodes_ended": n_done, "buffer_capacity": buf.capacity, "buffer_pos": buf.pos,
          "samples": cfg.batch_size, "seconds": time.perf_counter() - t0})


def stacked_builds_ms(buf, key, n, B, K, reps) -> dict:
    """Device ms of each build of ``replay_sample_stacked`` that the buffer takes."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.rl import buffers

    start, n_valid = buffers._stacked_window(buf, B, K)
    return {b: device_ms(lambda: kernels.replay_sample_stacked(buf.data, key, n, n_valid, start, B, K,
                                                               build=b), reps)
            for b in stacked_builds(buf.data, K)}


def _stacked_sample_bytes(buf, key, n, B, K) -> int:
    """Bytes that ``sample_with_next_stacked`` must move for this draw: each
    distinct entry, frame and done flag that it reads, once, and its two
    outputs.  The lookback of an anchor reads flags t-1 .. t-min(m+1, K-1)."""
    from tetris_gymnasium_torch.rl import buffers

    anchors, windows, depth = buffers.stacked_sample_rows(buf, key, n, B, K)
    frame, flag = nbytes(buf.data["obs"][0]), nbytes(buf.data["done"][0])
    fields = sum(nbytes(x[0]) for name, x in buf.data.items() if name not in ("obs", "done"))
    js = torch.arange(1, K, device=anchors.device)
    look = (anchors[..., None] - js * B) % buf.capacity
    flags = torch.cat([anchors.flatten(), look[js <= depth[..., None] + 1]])
    reads = (anchors.unique().numel() * fields + flags.unique().numel() * flag
             + windows.unique().numel() * frame)
    return reads + 2 * n * (K * frame + fields + flag)


def greedy_times(q) -> dict:
    """``dqn_act``'s greedy launch (no keys: the argmax, as the DQN
    evaluations launch it) beside ``torch.argmax(q, -1)``, the one PyTorch
    call that computes the same function (``library_ms``), and its bound."""
    from tetris_gymnasium_torch import kernels

    greedy = _bound(nbytes(q) + q.shape[0] * 4, q.shape[0] * DQN_ARGMAX_OPS_PER_ENV)
    kernel = kernels.dqn_act(q)
    library = torch.argmax(q, -1)
    if not torch.equal(kernel.long(), library):
        raise AssertionError("dqn_act's argmax differs from torch.argmax")
    return {"greedy_ms": device_ms(lambda: kernels.dqn_act(q), 100),
            "library_ms": device_ms(lambda: torch.argmax(q, -1), 100),
            "greedy_bound_ms": greedy["bound_ms"], "greedy_bound_by": greedy["bound_by"]}


DQN_ACT_OTHER_A = (5, 40)  # the generic dqn_act build's action counts held beside A = 8


def _act_edge_rows(q):
    """``q`` with the argmax's edge cases written into some rows: NaNs
    (first, last, every other, all), ties, +-inf, all-equal rows."""
    q = q.clone()
    A = q.shape[1]
    q[::7] = torch.round(q[::7])
    q[1::11, 0] = float("nan")
    q[2::11, A - 1] = float("nan")
    q[3::11, ::2] = float("nan")
    q[4::11, A // 2] = float("inf")
    q[5::11] = float("-inf")
    q[6::11, 1 % A] = float("inf")
    q[6::11, A - 1] = float("inf")
    q[7::11] = 0.25
    q[9::11] = float("nan")
    return q


def dqn_act_builds_diff(q, act_key, eps_key, what, offsets=None) -> int:
    """Every ``dqn_act`` build bit-equal to ``act_plain`` on ``q``'s rows with
    the argmax's edge cases written in (:func:`_act_edge_rows`): the A = 8
    build from ``q`` (B x 8) and the build for any other A from its first 5
    columns and from ``q`` tiled to 40, each greedy and with keys at the
    global counter offsets ``offsets`` (0, B and 3B by default), its randint
    draws and uniforms against the host twins'.  Returns the comparisons."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import dqn

    B, dev = q.shape[0], q.device
    offsets = (0, B, 3 * B) if offsets is None else offsets
    n = 0
    for qa in (q, q[:, :DQN_ACT_OTHER_A[0]], q.repeat(1, DQN_ACT_OTHER_A[1] // q.shape[1])):
        qa = _act_edge_rows(qa.contiguous())
        A = qa.shape[1]
        diff("dqn_act", kernels.dqn_act(qa), dqn.act_plain(qa), f"{what} A={A} greedy")
        for off in offsets:
            a, ra, u = kernels.dqn_act(qa, act_key, eps_key, 0.5, return_draws=True, env_offset=off)
            tag = f"{what} A={A} offset={off}"
            diff("dqn_act", a, dqn.act_plain(qa, act_key, eps_key, 0.5, env_offset=off), f"{tag} actions")
            diff("dqn_act", ra, threefry.randint_lanes(act_key, B, A, dev, start=off).to(torch.int32),
                 f"{tag} randint")
            diff("dqn_act", u, threefry.uniform_lanes(eps_key, B, dev, start=off), f"{tag} uniforms")
        n += 1 + len(offsets)
    return n


def time_dqn_kernels(dev, smi) -> dict:
    """Phase 20: the DQN path's new kernels, and its replay kernels, beside their bounds."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import framestack, threefry
    from tetris_gymnasium_torch.rl import buffers, dqn

    g = torch.Generator(device=dev)
    g.manual_seed(20)
    K = 4
    out = {"framestack_push": {}, "dqn_act": {}, "replay_sample_stacked": {}}
    for B in DQN_TIME_B:
        big = B >= 65536
        stack, obs = _boards((B, K, 20, 10), g, dev), _boards((B, 20, 10), g, dev)
        done = torch.rand((B,), generator=g, device=dev) < 0.03
        # the lanes not done read their K - 1 kept frames; every lane reads
        # obs and done and writes K frames
        kept = (B - int(done.sum())) * nbytes(stack[0, 1:])
        out["framestack_push"][B] = timed_pair(
            lambda: kernels.framestack_push(stack, obs, done),
            lambda: framestack.push_plain(stack, obs, done), 100, 5 if big else 20,
            kept + nbytes(obs, done, stack), 0)
    for B in (DQN_ENVS, 65536):
        q = torch.randn((B, 8), generator=g, device=dev)
        act_key, eps_key = threefry.split(threefry.prng_key(B))
        dqn_act_builds_diff(q, act_key, eps_key, f"phase 20 B={B}")
        out["dqn_act"][B] = timed_pair(
            lambda: kernels.dqn_act(q, act_key, eps_key, 0.3),
            lambda: dqn.act_plain(q, act_key, eps_key, 0.3), 100, 10,
            nbytes(q) + B * 4, B * DQN_ACT_OPS_PER_ENV)
        out["dqn_act"][B].update(greedy_times(q))

    # the replay at the path's shape: 1024 envs, the full 262,144 entries
    B = DQN_ENVS
    window = _boards((B, K, 20, 10), g, dev)
    buf = buffers.create(_dqn_block(B, window, g, dev), dqn.DQNConfig().buffer_size, B)
    for _ in range(buf.capacity // B):
        buf = buffers.add(buf, _dqn_block(B, _boards((B, K, 20, 10), g, dev), g, dev))
    block = _dqn_block(B, window, g, dev)
    entry = sum(x[0].numel() * x.element_size() for x in buf.data.values())
    out["replay_add"] = timed_pair(lambda: buffers.add(buf, block),
                                   lambda: buffers.add_plain(buf, block), 100, 20, 2 * B * entry, 0)
    out["replay_add"]["library_ms"] = add_library_ms(buf.data, block, buf.pos, 100)
    key = threefry.prng_key(3)
    for n in (DQN_BATCH, 65536):
        out["replay_sample_stacked"][n] = timed_pair(
            lambda: buffers.sample_with_next_stacked(buf, key, n, B, K),
            lambda: buffers.sample_with_next_stacked_plain(buf, key, n, B, K), 100, 5 if n > B else 20,
            _stacked_sample_bytes(buf, key, n, B, K),
            n * (SAMPLE_INDEX_OPS + 2 * K * STACK_OPS_PER_FRAME))
        out["replay_sample_stacked"][n]["builds_ms"] = stacked_builds_ms(buf, key, n, B, K, 100)
    out["replay_sample"] = timed_pair(
        lambda: buffers.sample_with_next(buf, key, DQN_BATCH, B),
        lambda: buffers.sample_with_next_plain(buf, key, DQN_BATCH, B), 100, 20,
        4 * DQN_BATCH * entry, DQN_BATCH * SAMPLE_INDEX_OPS)
    emit({"phase": "dqn_times", **out, "buffer_capacity": buf.capacity,
          "buffer_mib": sum(nbytes(x) for x in buf.data.values()) / 2**20, "nvidia_smi": smi})
    return out



# ---------------------------------------------------------------------------
# 21.-25. the pixel CNN DQN slice
# ---------------------------------------------------------------------------


def _flagship_actions(B, g, dev):
    """Random actions biased towards hard drops and swaps."""
    p = torch.tensor(FLAGSHIP_ACTION_P, device=dev)
    return torch.multinomial(p.expand(B, -1), 1, replacement=True, generator=g)[:, 0].to(torch.int32)


def _flagship_vs_turbo(fs, ts, what, cfg=None) -> None:
    """The flagship state equals the turbo state of geometry ``cfg`` (by
    default the default one) field for field, its occupancy packed from the
    id board."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo

    if not torch.equal(bits(turbo.from_flagship(fs, cfg or EngineConfig()).rows), bits(ts.rows)):
        raise AssertionError(f"{what}: occupancy differs from turbo_step's")
    for k in turbo.FIELDS:
        if k == "rows":
            continue
        a, b = getattr(fs, k), getattr(ts, k)
        if a.ndim == 2 and k != "key":
            a = a.T
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: {k} differs from turbo_step's")


def _surgery_boards(s, g, dev):
    """Hand-built id boards: garbage in rows 8-19 and 0..6 full bottom rows,
    random pieces, rotations and positions."""
    B = s.board.shape[0]
    board = s.board.clone()
    inner = board[:, 8:20, 4:14]
    garbage = torch.randint(2, 9, inner.shape, generator=g, device=dev, dtype=torch.int8)
    keep = torch.rand(inner.shape, generator=g, device=dev) < 0.6
    n_full = torch.randint(0, 7, (B,), generator=g, device=dev)
    full = (torch.arange(8, 20, device=dev)[None, :] >= 20 - n_full[:, None])[:, :, None]
    inner[:] = torch.where(keep | full, garbage, 0)
    return s.replace(
        board=board,
        piece=torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32),
        rotation=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32),
        x=torch.randint(-3, 18, (B,), generator=g, device=dev, dtype=torch.int32),
        y=torch.randint(0, 5, (B,), generator=g, device=dev, dtype=torch.int32),
    ), n_full


def _scrambled(s, cfg, P, g, dev):
    """``s`` with random id stacks (negative ids and ids past the palette
    among them) in the first half of its envs, the piece anywhere (past the
    walls and the floor, its id and rotation outside the table), odd
    holder counts and ``game_over`` on some envs."""
    B, H, PW = s.board.shape
    S, n = _side(P), int(P.ids.shape[0])
    half = (torch.arange(B, device=dev) < (B + 1) // 2)

    def ints(lo, hi, shape=(B,)):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    stack = torch.where(torch.rand((B, H, PW), generator=g, device=dev) < 0.35,
                        ints(-3, 12, (B, H, PW)).to(torch.int8), s.board)
    pick = half[:, None, None]
    return s.replace(
        board=torch.where(pick, stack, s.board).contiguous(),
        piece=torch.where(half, ints(-1, n + 2), s.piece), rotation=torch.where(half, ints(-1, 5), s.rotation),
        x=torch.where(half, ints(-S - 2, PW + 2), s.x), y=torch.where(half, ints(-S - 2, H + 2), s.y),
        holder_count=torch.where(half, ints(-1, cfg.holder_size + 2), s.holder_count),
        game_over=torch.where(half, torch.rand((B,), generator=g, device=dev) < 0.3, s.game_over))


def observation_choices_diff(dev, cfg, P, what, names=("observe_dict", "flagship_observe_board")) -> dict:
    """``observe_dict`` (and its strips-only mode) and
    ``flagship_observe_board`` against their plain versions at B = 1 and at
    batches that give each of their launches' envs-a-block choices (1..8
    envs or warps a block, the last block ragged; the observation's build of
    one env a warp at each, its build of more at the batches past 16 warps
    an SM): the states of 8 random steps, half their envs scrambled
    (:func:`_scrambled`)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import RewardsMapping
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    out = {}
    for name in names:
        batches = [1] + [sms * (k - 1) + 1 for k in range(2, 9)] + [sms * 8 + 3]
        if name == "observe_dict":
            def choice(B):
                return 1, kernels.observe_dict_shape(cfg, P, B)["envs_per_block"]
        else:
            def choice(B):
                shape = kernels.flagship_observe_board_shape(cfg, P, B)
                return shape["envs_per_warp"], shape["warps_per_block"]
            # past 16 warps an SM the observation's build of more envs a warp
            big = choice(16 * sms + 1)[0]
            batches += sorted({16 * sms + 1} | {b for b in (big * sms * (k - 1) + 1 for k in range(2, 9))
                                                if b > 16 * sms} | {big * sms * 8 + 3} - set(batches))
        chosen = []
        for B in batches:
            chosen.append(choice(B))
            s = kernels.flagship_init(batch_keys(prng_key(220 + B), B, device=dev), cfg, P)
            for _ in range(8):
                s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, RewardsMapping())[0]
            s = _scrambled(s, cfg, P, g, dev)
            at = f"{what} B={B} ({chosen[-1]}: envs a warp, a block)"
            if name == "observe_dict":
                d, dp = kernels.observe_dict(s, cfg, P), engine.observe_dict_plain(s, cfg, P)
                for k in dp:
                    diff("observe_dict", d[k], dp[k], f"{at} {k}")
                strips = kernels.observe_dict(s, cfg, P, strips_only=True)
                if sorted(strips) != ["holder", "queue"]:
                    raise AssertionError(f"{at}: observe_dict strips_only wrote {sorted(strips)}")
                for k in strips:
                    diff("observe_dict", strips[k], dp[k], f"{at} strips_only {k}")
            else:
                diff("flagship_observe_board", kernels.flagship_observe_board(s, cfg, P),
                     engine.observe_board_plain(s, cfg, P), at)
        if sorted({w for e, w in chosen if e == 1}) != list(range(1, 9)):
            raise AssertionError(f"{what} {name}: the batches chose {chosen}, not every count 1..8")
        out[name] = {"batches": batches, "envs_per_warp_and_per_block": chosen}
    return out


def init_edges_diff(dev, cfg, P, what) -> list:
    """``flagship_init`` against ``engine.init_plain`` in both queue kinds at
    B = 1, 31 and 33, at batches that leave a part-full last block of a few
    envs and of 256 (``kernels.flagship_init_shape``), and at the vector
    env's 8192; returns the batches."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    batches = (1, 31, 33, 4 * sms + 3, 256 * sms + 5, VECTOR_B)
    for kind in ("bag", "uniform"):
        c = cfg._replace(queue_kind=kind)
        for B in batches:
            keys = batch_keys(prng_key(B + 21), B, device=dev)
            got, want = kernels.flagship_init(keys, c, P), engine.init_plain(keys, c, P)
            _fields_diff("flagship_init", got, want, engine.FIELDS, f"{what} {kind} B={B}")
    return list(batches)


def check_flagship(dev) -> None:
    """Phases 21-22: ``flagship_init``, ``flagship_step``,
    ``flagship_observe_board`` and ``render_rgb84`` against their plain
    versions, bit for bit, and the flagship trajectories against
    ``turbo_step``'s on the same keys and actions; both observation kernels
    at every envs-a-block choice (:func:`observation_choices_diff`)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    def state_diff(kernel, ks, ps, what):
        for k in engine.FIELDS:
            diff(kernel, getattr(ks, k), getattr(ps, k), f"{what}: {k}")

    def obs_checks(s, cfg, what, ts=None):
        ob = kernels.flagship_observe_board(s, cfg, engine.PIECES)
        diff("flagship_observe_board", ob, engine.observe_board_plain(s, cfg), f"{what} obs")
        if ts is not None and not torch.equal(ob, kernels.observe_board(ts, cfg, turbo.PIECES)):
            raise AssertionError(f"{what}: board observation differs from the turbo engine's")
        diff("render_rgb84", kernels.render_rgb84(s, cfg, engine.PIECES),
             engine.render_rgb84_plain(s, cfg), f"{what} rgb84")

    g = torch.Generator(device=dev)
    g.manual_seed(21)
    t0 = time.perf_counter()
    for B in (PIX_ENVS, 1, 1001):
        for kind in ("bag", "uniform"):
            cfg = EngineConfig(queue_kind=kind)
            keys = batch_keys(prng_key(B), B, device=dev)
            state_diff("flagship_init", kernels.flagship_init(keys, cfg, engine.PIECES),
                       engine.init_plain(keys, cfg), f"init B={B} {kind}")
    init_batches = init_edges_diff(dev, EngineConfig(), engine.PIECES, "phase 21 init")
    # PPO's rollout step on this engine: the action sampled in the step's launch
    sampled = check_flagship_sample_builds(dev, EngineConfig(auto_reset=True), engine.PIECES, "10x20", 21)

    runs = [
        ("autoreset", PIX_ENVS, EngineConfig(auto_reset=True), RewardsMapping()),
        ("nograv-frozen", PIX_ENVS, EngineConfig(gravity_enabled=False),
         RewardsMapping(alife=0.5, game_over=-2.0)),
        ("uniform-autoreset-nograv", 1001,
         EngineConfig(auto_reset=True, gravity_enabled=False, queue_kind="uniform"), RewardsMapping()),
        ("uniform-frozen", 1, EngineConfig(queue_kind="uniform"), RewardsMapping()),
    ]
    summary = []
    counts = {"steps": 0, "obs": 0, "holder_full": 0, "game_over_frames": 0, "builds": 0}
    for name, B, cfg, rw in runs:
        keys = batch_keys(prng_key(7), B, device=dev)
        s = kernels.flagship_init(keys, cfg, engine.PIECES)
        ts = kernels.turbo_init(keys, cfg, turbo.PIECES)
        n_done = n_lines = 0
        for i in range(FLAGSHIP_STEPS):
            obs_checks(s, cfg, f"{name} @ {i}", ts)
            counts["obs"] += 1
            a = _flagship_actions(B, g, dev)
            want = engine.step_plain(s, a, cfg, rewards=rw)
            ks, kr, kd, kl = flagship_builds_diff([(s, a)], cfg, engine.PIECES, rw, want,
                                                  f"{name} step {i}")[0]
            counts["builds"] += len(kernels.FLAGSHIP_LANES)
            ts, tr, td, tl = kernels.turbo_step(ts, a, cfg, turbo.PIECES, rw)
            _flagship_vs_turbo(ks, ts, f"{name} step {i}")
            for got, want, what in ((kr, tr, "reward"), (kd, td, "done"), (kl, tl, "lines")):
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(f"{name} {what} @ {i}: flagship and turbo differ")
            counts["steps"] += 1
            counts["holder_full"] += int((ks.holder_count >= cfg.holder_size).sum())
            counts["game_over_frames"] += int(s.game_over.sum())
            n_done += int((kd & ~s.game_over).sum())
            n_lines += int(kl.sum())
            s = ks
        obs_checks(s, cfg, f"{name} end", ts)
        summary.append({"run": name, "B": B, "steps": FLAGSHIP_STEPS, "episodes_ended": n_done,
                        "lines": n_lines})

    # hand-built boards: multi-line clears past the turbo engine's envelope
    cfg = EngineConfig(auto_reset=True)
    s = kernels.flagship_init(batch_keys(prng_key(8), PIX_ENVS, device=dev), cfg, engine.PIECES)
    s, n_full = _surgery_boards(s, g, dev)
    clears = torch.zeros(16, dtype=torch.int64)
    for i in range(FLAGSHIP_STEPS):
        obs_checks(s, cfg, f"surgery @ {i}")
        a = _flagship_actions(PIX_ENVS, g, dev)
        if i == 0:
            a = torch.full_like(a, 5)  # hard drops onto the full rows
        ks, kr, kd, kl = flagship_builds_diff([(s, a)], cfg, engine.PIECES, RewardsMapping(),
                                              engine.step_plain(s, a, cfg), f"surgery step {i}")[0]
        counts["builds"] += len(kernels.FLAGSHIP_LANES)
        clears += torch.bincount(kl.long().cpu(), minlength=16)[:16]
        s = ks
    choices = observation_choices_diff(dev, EngineConfig(auto_reset=True), engine.PIECES, "phase 22")
    torch.cuda.synchronize()
    if int(clears[2:].sum()) == 0 or int(clears[5:].sum()) == 0:
        raise AssertionError(f"the hand-built boards cleared no multi-line stack: {clears.tolist()}")
    if counts["holder_full"] == 0 or counts["game_over_frames"] == 0:
        raise AssertionError(f"the trajectories missed a full holder or a game-over frame: {counts}")
    emit({"phase": "flagship_engine", "bit_equal": True, "turbo_equal": True, "runs": summary,
          "flagship_step_lanes": list(kernels.FLAGSHIP_LANES),
          "surgery_lines_per_lock": {n: int(c) for n, c in enumerate(clears.tolist()) if c},
          **counts, "init_edge_batches": init_batches, "sample": sampled,
          "max_abs_err": {k: MAX_ERR[k] for k in ("flagship_init", "flagship_step")},
          "seconds": time.perf_counter() - t0})
    emit({"phase": "flagship_obs", "bit_equal": True, "turbo_equal": True,
          "comparisons": counts["obs"] + FLAGSHIP_STEPS + len(runs), "launch_choices": choices,
          "max_abs_err": {k: MAX_ERR[k] for k in ("flagship_observe_board", "render_rgb84")}})


def eval_flagship_board(dev, net, turbo_stats) -> dict:
    """The ``--impl flagship --obs board`` path: the committed PPO policy's
    512 greedy games (phase 5) on the flagship engine, which plays the turbo
    engine's game, so its statistics equal phase 5's."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl.evaluate import evaluate_policy, greedy_logits

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = evaluate_policy(greedy_logits(net), EVAL_EPISODES, EngineConfig(), prng_key(EVAL_SEED),
                            impl="flagship", max_steps=EVAL_MAX_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    it = stats["iterations"]
    want = {**{k: 0 for k in launches}, "flagship_init": 1, "flagship_step": it,
            "flagship_observe_board": it}
    if launches != want:
        raise AssertionError(f"flagship evaluation launch counts {launches}, want {want}")
    if stats != turbo_stats:
        raise AssertionError(f"flagship evaluation {stats} differs from the turbo engine's {turbo_stats}")
    emit({"phase": "flagship_eval", "stats": stats, "equal_to_turbo": True, "launches": launches,
          "seconds": wall, "ms_per_iteration": 1e3 * wall / max(it, 1)})
    return {"launches": launches, "iterations": it}


def check_small_pixel_dqn() -> None:
    """Phase 23: a small fp32 pixel DQN on the card against the same run on the CPU."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.models.networks import AtariQNetwork
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import dqn
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    env_config = EngineConfig(auto_reset=True)
    cfg = dqn.DQNConfig(**SMALL_PIX_CFG)
    start = load_flat(PIX_INIT)
    runs = {}
    with deterministic_cudnn():
        for where in ("cuda", "cpu"):
            ts = dqn.init_dqn_state(prng_key(3), SMALL_PIX_ENVS, env_config, cfg,
                                    net=AtariQNetwork(in_channels=4, dtype=torch.float32),
                                    impl="flagship", obs="rgb84", device=where, params=start)
            step = dqn.make_train_step(env_config, cfg, impl="flagship", obs="rgb84")
            losses, dones = [], 0
            for _ in range(SMALL_PIX_STEPS):
                ts, m = step(ts)
                losses.append(float(m["loss"]))
                dones += int(m["episodes_done"])
            runs[where] = (ts, losses, dones)
    (tc, lc, dc), (tp, lp, _) = runs["cuda"], runs["cpu"]
    for k, v in tc.buffer.data.items():
        if not torch.equal(bits(v.cpu()), bits(tp.buffer.data[k])):
            raise AssertionError(f"small pixel DQN: replay {k} differs between card and CPU")
    for k in engine.FIELDS:
        if not torch.equal(bits(getattr(tc.env_states, k).cpu()), bits(getattr(tp.env_states, k))):
            raise AssertionError(f"small pixel DQN: env {k} differs between card and CPU")
    if not torch.equal(tc.obs.cpu(), tp.obs):
        raise AssertionError("small pixel DQN: the window differs between card and CPU")
    pc, pp = to_flax_params(tc.net.state_dict(), "atari_q"), to_flax_params(tp.net.state_dict(), "atari_q")
    norm_worst, elem_worst = param_change_diff("small pixel DQN", start, pc, pp, SMALL_PIX_PARAM_TOL)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lc, lp))
    emit({"phase": "small_pixel_dqn", "replay_bit_equal": True, "env_bit_equal": True,
          "window_bit_equal": True, "envs": SMALL_PIX_ENVS, "steps": SMALL_PIX_STEPS,
          "episodes_done": dc, "param_change_max_norm_rel_diff": norm_worst,
          "param_change_max_elem_rel_diff": elem_worst, "loss_max_rel_diff": loss_rel,
          "loss_last": [lc[-1], lp[-1]], "seconds": time.perf_counter() - t0})


def _chunks250(values, per):
    """Means of consecutive 250-step windows of per-``per``-step records."""
    n = 250 // per
    return [sum(values[i : i + n]) / n for i in range(0, len(values) - n + 1, n)]


def train_pixel_dqn_full_width(dev, smi) -> dict:
    """Phase 24: ``examples/train_cnn.py --obs rgb84 --frame-stack 4`` at the
    committed run's shape."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.examples import train_cnn
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.rl import dqn
    from tetris_gymnasium_torch.rl.evaluate import evaluate_q_checkpoint
    from tetris_gymnasium_torch.utils.checkpoint import load_flat, load_q_net

    args = train_cnn.parse_args([
        "--obs", "rgb84", "--frame-stack", "4", "--n-envs", str(PIX_ENVS), "--steps", str(PIX_STEPS),
        "--chunk", str(PIX_CHUNK), "--exploration-steps", str(PIX_EXPLORATION),
        "--learning-starts", str(PIX_LEARNING_STARTS), "--seed", "1", "--init-params", PIX_INIT])
    events = []

    def mark(name):
        if name == "start":
            events.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1][name] = ev

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, records = train_cnn.train(args, marks=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n, learn = PIX_STEPS, PIX_STEPS - PIX_LEARNING_STARTS
    want = {**{k: 0 for k in launches}, "flagship_init": 1, "flagship_step": n, "render_rgb84": n + 1,
            "dqn_act": n, "replay_add": n, "framestack_push": n, "replay_sample_stacked": learn}
    if launches != want:
        raise AssertionError(f"pixel DQN launch counts {launches}, want {want}")
    for rec in records:
        for k, v in rec.items():
            if not np.isfinite(v):
                raise AssertionError(f"pixel DQN metric {k} is not finite: {rec}")
    start = load_flat(PIX_INIT)
    trained = to_flax_params(ts.net.state_dict(), "atari_q")
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in start}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"some parameters did not move: {moved}")
    chunks = _chunks250([r["reward_per_step"] for r in records], PIX_CHUNK)
    with open(PIX_JAX_CURVE) as f:
        jax_records = [json.loads(line)["reward_per_step"] for line in f]
    jax_chunks = _chunks250(jax_records[: PIX_STEPS // PIX_CHUNK], PIX_CHUNK)
    first, jax_first = sum(chunks[:2]) / 2, sum(jax_chunks[:2]) / 2
    ratio, jax_ratio = chunks[-1] / first, jax_chunks[-1] / jax_first
    learning = events[PIX_LEARNING_STARTS + 10:]
    split = {"before_learning": split_ms(events[10:PIX_LEARNING_STARTS]), "learning": split_ms(learning)}
    emit({"phase": "pixel_dqn_train", "n_envs": PIX_ENVS, "steps": n, "wall_s_with_setup": wall,
          "launches": launches, "reward_per_step_250": chunks, "jax_reward_per_step_250": jax_chunks,
          "steps_per_episode_chunks": [r["steps_per_episode"] for r in records],
          "epsilon_last": records[-1]["epsilon"], "loss_last": records[-1]["loss"],
          "start_mean": first, "jax_start_mean": jax_first, "gate_ratio": ratio,
          "jax_gate_ratio": jax_ratio, "gate": PIX_GATE, "step_split_ms": split,
          "env_steps_per_s_learning": PIX_ENVS / (split["learning"]["step"] * 1e-3),
          "param_max_change": moved, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "nvidia_smi": smi})
    if abs(first - jax_first) > PIX_START_TOL:
        raise AssertionError(f"pixel DQN start: steps 1-500 give {first} reward per step, JAX "
                             f"{jax_first}; want within {PIX_START_TOL}")
    if not ratio >= PIX_GATE:
        raise AssertionError(f"pixel DQN learning gate: steps 1751-2000 give {chunks[-1]} reward "
                             f"per step, {ratio:.3f}x steps 1-500 ({first}); want {PIX_GATE}x")

    t0 = time.perf_counter()
    evals = {}
    for name, net in (("untrained", load_q_net(PIX_INIT, "atari_q", device=dev)), ("trained", ts.net)):
        kernels.reset_launches()
        evals[name] = evaluate_q_checkpoint(net, EVAL_EPISODES, EngineConfig(), seed=EVAL_SEED,
                                            impl="flagship", max_steps=EVAL_MAX_STEPS, frame_stack=4,
                                            obs="rgb84", device=dev)
        torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)  # the trained net's evaluation
    it = evals["trained"]["iterations"]
    want = {**{k: 0 for k in launches}, "flagship_init": 1, "flagship_step": it, "dqn_act": it,
            "render_rgb84": it + 1, "framestack_push": it}
    if eval_launches != want:
        raise AssertionError(f"pixel DQN evaluation launch counts {eval_launches}, want {want}")
    emit({"phase": "pixel_dqn_eval", "episodes": EVAL_EPISODES, "max_steps": EVAL_MAX_STEPS,
          **evals, "launches_trained": eval_launches, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    cfg = dqn.DQNConfig(exploration_steps=PIX_EXPLORATION, learning_starts=PIX_LEARNING_STARTS,
                        frame_stack=4)
    step = dqn.make_train_step(EngineConfig(auto_reset=True), cfg, impl="flagship", obs="rgb84")
    ts, busy = profile_steps(step, ts)
    emit({"phase": "pixel_dqn_profile", **busy, "nvidia_smi": smi})
    check_pixel_path_shapes(dev, ts, cfg)
    return {"launches": launches, "eval_launches": eval_launches, "split": split}


def check_pixel_path_shapes(dev, ts, cfg) -> None:
    """The end of phase 24: every kernel of the pixel path against its plain
    version at the path's shapes, on its trained state."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops import framestack, threefry
    from tetris_gymnasium_torch.rl import buffers, dqn

    t0 = time.perf_counter()
    K = cfg.frame_stack
    env_config = EngineConfig(auto_reset=True)
    with torch.no_grad():
        q = ts.net(ts.obs)
    act_key, eps_key = threefry.split(threefry.fold_in(threefry.prng_key(24), ts.step))
    a = kernels.dqn_act(q, act_key, eps_key, 0.5)
    diff("dqn_act", a, dqn.act_plain(q, act_key, eps_key, 0.5), "trained state actions")
    s = ts.env_states
    ks, kr, kd, kl = flagship_builds_diff([(s, a)], env_config, engine.PIECES, RewardsMapping(),
                                          engine.step_plain(s, a, env_config), "trained step")[0]
    raw = kernels.render_rgb84(ks, env_config, engine.PIECES)
    diff("render_rgb84", raw, engine.render_rgb84_plain(ks, env_config), "trained frame")
    diff("flagship_observe_board", kernels.flagship_observe_board(ks, env_config, engine.PIECES),
         engine.observe_board_plain(ks, env_config), "trained board")
    n_done = int(kd.sum())
    if n_done == 0:
        raise AssertionError("the trained step ended no episode, so no window restarted")
    diff("framestack_push", kernels.framestack_push(ts.obs, raw, kd),
         framestack.push_plain(ts.obs, raw, kd), "trained window push")

    buf = ts.buffer
    if buf.size != buf.capacity or buf.pos == 0:
        raise AssertionError(f"the buffer is not full and wrapped: pos {buf.pos}, size {buf.size}")
    block = {"obs": ts.obs[:, -1], "action": a, "reward": kr, "done": kd}
    kbuf, pbuf = (buffers.ReplayBuffer({k: v.clone() for k, v in buf.data.items()}, buf.pos, buf.size)
                  for _ in range(2))
    kbuf, pbuf = buffers.add(kbuf, block), buffers.add_plain(pbuf, block)
    for k in buf.data:
        diff("replay_add", kbuf.data[k], pbuf.data[k], f"full buffer add {k}")
    key = threefry.fold_in(threefry.prng_key(25), ts.step)
    kc, kn = buffers.sample_with_next_stacked(kbuf, key, cfg.batch_size, PIX_ENVS, K)
    pc, pn = buffers.sample_with_next_stacked_plain(pbuf, key, cfg.batch_size, PIX_ENVS, K)
    for k in buf.data:
        diff("replay_sample_stacked", kc[k], pc[k], f"full buffer sample {k}")
        diff("replay_sample_stacked", kn[k], pn[k], f"full buffer successor {k}")
    if stacked_builds(kbuf.data, K) != ["bulk", "words"]:
        raise AssertionError("the pixel buffer's 7056-byte frames do not take the bulk build")
    stacked_builds_diff(kbuf, key, cfg.batch_size, PIX_ENVS, K, (pc, pn), "full buffer")
    del kbuf, pbuf
    torch.cuda.synchronize()
    emit({"phase": "pixel_path_shapes", "bit_equal": True, "B": PIX_ENVS, "episodes_ended": n_done,
          "lines_cleared": int(kl.sum()), "buffer_capacity": buf.capacity, "buffer_pos": buf.pos,
          "samples": cfg.batch_size, "seconds": time.perf_counter() - t0})


def _playfield(board, cfg):
    """The cells of id boards ``[B, H+pad, W+2pad]`` that a board observation
    reads: the playfield's rows and columns, no bedrock."""
    return board[:, : cfg.height, cfg.padding : cfg.padding + cfg.width]


def _render_bytes(s, B) -> int:
    """What ``render_rgb84`` must move: the fields it reads, once, and the frames."""
    return nbytes(s.board, s.piece, s.rotation, s.x, s.y, s.queue, s.holder_piece,
                  s.holder_rotation, s.holder_count) + B * 84 * 84


def time_pixel_kernels(dev, smi) -> dict:
    """Phase 25: the flagship kernels beside their bounds and the launch
    floor at the path's shape (B = 512), pixel PPO's (2048) and 65536, with
    each ``flagship_step`` build and ``render_rgb84``'s bound under the 2-D
    count too, and the reused kernels at the 7056-byte frame (512, 65536)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops import framestack, threefry
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.rl import buffers, dqn

    g = torch.Generator(device=dev)
    g.manual_seed(25)
    cfg = EngineConfig(auto_reset=True)
    out = {k: {} for k in ("flagship_step", "flagship_init", "flagship_observe_board", "render_rgb84",
                           "framestack_push", "dqn_act", "replay_sample_stacked")}

    def state_bytes(s):
        return nbytes(*(getattr(s, k) for k in engine.FIELDS))

    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    for B in PIX_FLAGSHIP_TIME_B:
        big = B >= 65536
        keys = batch_keys(prng_key(B), B, device=dev)
        s = kernels.flagship_init(keys, cfg, engine.PIECES)
        for _ in range(40):  # mid-game boards
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, engine.PIECES,
                                      RewardsMapping())[0]
        a = _flagship_actions(B, g, dev)
        pb = min(B, PIX_PLAIN_MAX_B)  # the plain versions' batch
        ps = engine.EngineState(**{k: (getattr(s, k)[:, :pb] if k == "key" else getattr(s, k)[:pb])
                                   for k in engine.FIELDS})
        ps = ps.replace(**{k: getattr(ps, k).contiguous() for k in engine.FIELDS})
        scale = B / pb  # plain ms at pb, scaled to B
        entries = {
            "flagship_step": (lambda: kernels.flagship_step(s, a, cfg, engine.PIECES, RewardsMapping()),
                              lambda: engine.step_plain(ps, a[:pb], cfg),
                              2 * state_bytes(s) + nbytes(a) + B * (4 + 1 + 4),
                              B * FLAGSHIP_STEP_OPS_PER_ENV),
            "flagship_init": (lambda: kernels.flagship_init(keys, cfg, engine.PIECES),
                              lambda: engine.init_plain(keys[:pb], cfg),
                              nbytes(keys) + state_bytes(s), B * FLAGSHIP_INIT_OPS_PER_ENV),
            "flagship_observe_board": (
                lambda: kernels.flagship_observe_board(s, cfg, engine.PIECES),
                lambda: engine.observe_board_plain(ps, cfg),
                nbytes(_playfield(s.board, cfg), s.piece, s.rotation, s.x, s.y, s.game_over) + B * 200,
                B * FLAGSHIP_OBS_OPS_PER_ENV),
            "render_rgb84": (lambda: kernels.render_rgb84(s, cfg, engine.PIECES),
                             lambda: engine.render_rgb84_plain(ps, cfg),
                             _render_bytes(s, B), B * render_ops(cfg.padded_height)),
        }
        for name, (kernel_fn, plain_fn, io, ops) in entries.items():
            entry = timed_pair(kernel_fn, plain_fn, 20 if big else 100, 2 if big else 10, io, ops)
            entry.update(plain_ms=entry["plain_ms"] * scale, plain_B=pb, floor_ms=floor_ms)
            entry["env_steps_per_s" if name == "flagship_step" else "envs_per_s"] = B / (entry["ms"] * 1e-3)
            out[name][B] = entry
        out["flagship_step"][B]["lanes"] = kernels.flagship_step_lanes(B, cfg.padded_height)
        out["flagship_step"][B]["builds_ms"] = {
            lanes: device_ms(lambda: kernels.flagship_step(s, a, cfg, engine.PIECES, RewardsMapping(),
                                                           lanes=lanes), 20 if big else 100)
            for lanes in kernels.FLAGSHIP_LANES}
        out["render_rgb84"][B]["bound_ms_2d"] = _bound(
            _render_bytes(s, B), B * 84 * 84 * RENDER_OPS_PER_PIXEL_2D)["bound_ms"]

    # the reused kernels at the pixel path's 7056-byte frame
    K = 4
    for B in PIX_TIME_B:
        big = B >= 65536
        stack = torch.randint(0, 256, (B, K, 84, 84), generator=g, device=dev, dtype=torch.uint8)
        obs = torch.randint(0, 256, (B, 84, 84), generator=g, device=dev, dtype=torch.uint8)
        done = torch.rand((B,), generator=g, device=dev) < 0.03
        kept = (B - int(done.sum())) * nbytes(stack[0, 1:])
        out["framestack_push"][B] = timed_pair(
            lambda: kernels.framestack_push(stack, obs, done),
            lambda: framestack.push_plain(stack, obs, done), 20 if big else 100, 3 if big else 20,
            kept + nbytes(obs, done, stack), 0)
        del stack, obs
    q = torch.randn((PIX_ENVS, 8), generator=g, device=dev)
    act_key, eps_key = threefry.split(threefry.prng_key(PIX_ENVS))
    dqn_act_builds_diff(q, act_key, eps_key, f"phase 25 B={PIX_ENVS}")
    out["dqn_act"][PIX_ENVS] = timed_pair(
        lambda: kernels.dqn_act(q, act_key, eps_key, 0.3),
        lambda: dqn.act_plain(q, act_key, eps_key, 0.3), 100, 10, nbytes(q) + PIX_ENVS * 4,
        PIX_ENVS * DQN_ACT_OPS_PER_ENV)
    out["dqn_act"][PIX_ENVS].update(greedy_times(q))

    B = PIX_ENVS
    window = torch.randint(0, 256, (B, K, 84, 84), generator=g, device=dev, dtype=torch.uint8)

    def block():
        return _dqn_block(B, window, g, dev)

    buf = buffers.create(block(), dqn.DQNConfig().buffer_size, B)
    for _ in range(buf.capacity // B):
        window.random_(0, 256, generator=g)
        buf = buffers.add(buf, block())
    blk = block()
    entry = sum(x[0].numel() * x.element_size() for x in buf.data.values())
    out["replay_add"] = timed_pair(lambda: buffers.add(buf, blk), lambda: buffers.add_plain(buf, blk),
                                   100, 20, 2 * B * entry, 0)
    out["replay_add"]["library_ms"] = add_library_ms(buf.data, blk, buf.pos, 100)
    # the earlier yardstick, the ring write as one index_copy_ a field (the
    # port never calls it), kept beside the obs field's copy_
    ring = torch.arange(buf.pos, buf.pos + B, device=dev)
    out["replay_add"]["index_copy_ms"] = device_ms(
        lambda: [store.index_copy_(0, ring, blk[k]) for k, store in buf.data.items()], 100)
    key = threefry.prng_key(3)
    for n in (PIX_BATCH, 65536):
        out["replay_sample_stacked"][n] = timed_pair(
            lambda: buffers.sample_with_next_stacked(buf, key, n, B, K),
            lambda: buffers.sample_with_next_stacked_plain(buf, key, n, B, K), 20 if n > B else 100,
            3 if n > B else 20, _stacked_sample_bytes(buf, key, n, B, K),
            n * (SAMPLE_INDEX_OPS + 2 * K * STACK_OPS_PER_FRAME))
        out["replay_sample_stacked"][n]["builds_ms"] = stacked_builds_ms(buf, key, n, B, K,
                                                                         20 if n > B else 100)
    emit({"phase": "pixel_times", **out, "buffer_capacity": buf.capacity,
          "buffer_gib": sum(nbytes(x) for x in buf.data.values()) / 2**30, "nvidia_smi": smi})
    del buf
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 26.-30. the Gymnasium surface
# ---------------------------------------------------------------------------

SURFACE_B = (4096, 1001, 1)
SURFACE_STEPS = 300
SURFACE_GROUPED_EVERY = 10  # grouped_flagship against its plain version every 10th state
SURFACE_FLAGS_EVERY = 50  # and under all 16 flag sets every 50th
SURFACE_FORCED_EVERY = 25  # feature_vector's and compose_rgb's forced builds every 25th
SURFACE_TURBO_STEPS = 100  # flagship grouped against turbo grouped at B = 4096
SHELL_EPISODES, SHELL_MAX_STEPS = 20, 300
SHELL_ACTIONS = (-1, 8, 11) + tuple(range(8))  # out-of-range ids are no-ops with gravity
SHELL_ACTION_P = (0.02, 0.02, 0.02) + (0.1, 0.1, 0.08, 0.1, 0.07, 0.3, 0.07, 0.12)
WRAPPER_EPISODES, WRAPPER_MAX_STEPS = 3, 40
GROUPED_ENGINE_B, GROUPED_ENGINE_STEPS = 4096, 32  # bench.py:402-406
VECTOR_B, VECTOR_STEPS = 8192, 64  # bench.py:419
# the kernels a TetrisVectorEnv step launches, both engines (phases 29 and 33; timed in phase 34)
VECTOR_ENV_KERNELS = ("turbo_init", "turbo_step", "observe_board", "flagship_init", "flagship_step",
                      "flagship_observe_board")
VECTOR_CHECK_STEPS = 16  # against the CPU; hard drops end episodes from step ~10, so final_obs is checked
VECTOR_DROP_P = (0.02, 0.02, 0.02, 0.02, 0.02, 0.86, 0.02, 0.02)
SURFACE_TIME_B = (1, 4096, 65536)
SURFACE_CANDIDATES = 40  # the grouped wrapper's candidates at 10x20 (phase 30 times its kernels there)
SURFACE_PLAIN_MAX_B = 4096  # the plain versions' batch; larger B scaled from it
SHELL_TIMED_STEPS = 200
# 32-bit operations the functions need (grouped_flagship's:
# grouped_flagship_ops): feature_vector 20 rows of 10 cells (3 each, 15 a
# row) and the read-out; observe_dict 432 board cells (10 each), 432 mask
# cells (8 each) and 80 strip cells (10 each); compose_rgb 12 a pixel
FEATURE_VECTOR_OPS_PER_ENV = 20 * (3 * 10 + 15) + 60
OBSERVE_DICT_OPS_PER_ENV = 10 * 432 + 8 * 432 + 10 * 80
COMPOSE_OPS_PER_PIXEL = 12
FLAG_SETS = tuple(tuple(bool(m >> k & 1) for k in range(4)) for m in range(16))


def _surface_actions(mask, g, dev, wild):
    """Random placements from a batch-leading mask ``[B, A]``."""
    import types

    return _grouped_actions(types.SimpleNamespace(mask=mask.T), g, dev, wild)


def _grouped_features_plain(boards, flags):
    """grouped_observation_plain's features, from the plain placements' boards."""
    from tetris_gymnasium_torch.ops.observations import feature_vector_plain

    B, A = boards.shape[:2]
    return feature_vector_plain(boards[:, :, :20, 4:14].reshape(B * A, 20, 10), flags) \
        .reshape(B, A, -1).to(torch.float32)


def compose_library_ms(board, queue, holder, group, pieces, n) -> float:
    """``compose_rgb``'s yardstick: one indexing call, ``palette_ext[ids]``,
    given the composed int64 id image (the board, the strips widened with
    bedrock, bedrock between) and the palette with black past its colours.
    Timed only; the port never calls it."""
    if group != 1:
        queue, holder = queue.repeat_interleave(group, 0), holder.repeat_interleave(group, 0)
    S, side = queue.shape[1], max(queue.shape[2], holder.shape[2])
    N, H = board.shape[:2]
    sidebar = torch.ones((N, H, side), dtype=torch.uint8, device=board.device)
    sidebar[:, :S, : queue.shape[2]] = queue
    sidebar[:, H - S:, : holder.shape[2]] = holder
    ids = torch.cat([board, sidebar], dim=2).long()
    pal = torch.zeros((256, 3), dtype=torch.uint8, device=board.device)
    pal[: pieces.palette.shape[0]] = torch.as_tensor(pieces.palette, device=board.device)
    return device_ms(lambda: pal[ids], n)


def feature_builds_diff(crop, flags, want, what, forced=True) -> None:
    """``feature_vector`` against ``want`` as the wrapper picks its build,
    and with ``forced`` in each build: the words build where the rows'
    words lie inside the storage, the bytes build."""
    from tetris_gymnasium_torch import kernels

    builds = ((True, False) if kernels._feature_words(crop) else (False,)) if forced else ()
    for words in (None, *builds):
        with kernels._forced("feature_vector", words):
            got = kernels.feature_vector(crop, flags)
        diff("feature_vector", got, want, f"{what} words={words}")


def compose_builds_diff(board, queue, holder, pieces, group, want, what, forced=True) -> None:
    """``compose_rgb`` against ``want`` as the wrapper picks its run
    length, and with ``forced`` at each (16 pixels a lane, 1)."""
    from tetris_gymnasium_torch import kernels

    for run in (None, 16, 1) if forced else (None,):
        with kernels._forced("compose_rgb", run):
            got = kernels.compose_rgb(board, queue, holder, pieces, group)
        diff("compose_rgb", got, want, f"{what} run={run}")


def wrapper_kernel_times(dev, cfg, P, batches, seed) -> dict:
    """``feature_vector`` and ``compose_rgb`` at the observation wrappers'
    own batches: B = 1 (the env's board) and A (the grouped wrapper's
    candidates: the host mode's boards, the rgb mode's composites with
    ``group`` = A and one env's strips), on mid-game boards, beside their
    plain versions, bounds and (``compose_rgb``) its yardstick."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import RewardsMapping
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb_plain, feature_vector_plain
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flags, pad = FeatureFlags(), cfg.padding
    H, PW, W, h = cfg.padded_height, cfg.padded_width, cfg.width, cfg.height
    out = {"feature_vector": {}, "compose_rgb": {}}
    for B in batches:
        s = kernels.flagship_init(batch_keys(prng_key(seed + B), B, device=dev), cfg, P)
        for _ in range(40):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, RewardsMapping())[0]
        d = kernels.observe_dict(s, cfg, P)
        group = 1 if B == 1 else B
        q, hd = d["queue"][: B // group].contiguous(), d["holder"][: B // group].contiguous()
        crop = s.board[:, :-pad, pad:-pad]
        iw = PW + max(q.shape[2], hd.shape[2])
        fv = timed_pair(lambda: kernels.feature_vector(crop, flags), lambda: feature_vector_plain(crop, flags),
                        100, 10, B * (h * W + 4 * (W + 3)), B * (h * (3 * W + 15) + 6 * W))
        fv.update(library_ms=None, launch=kernels.feature_vector_shape(h, W, B))
        cr = timed_pair(lambda: kernels.compose_rgb(d["board"], q, hd, P, group),
                        lambda: compose_rgb_plain(d["board"], q, hd, P, group), 100, 10,
                        B * (H * PW + 3 * H * iw) + nbytes(q, hd), B * H * iw * COMPOSE_OPS_PER_PIXEL)
        cr.update(library_ms=compose_library_ms(d["board"], q, hd, group, P, 100), group=group,
                  library_call="palette_ext[id_image], given the composed int64 id image",
                  launch=kernels.compose_rgb_shape(cfg, P, B))
        out["feature_vector"][B], out["compose_rgb"][B] = fv, cr
        del s, d, crop
    return out


def check_surface_kernels(dev) -> dict:
    """Phase 26: ``grouped_flagship`` (ids, boards, features), ``feature_vector``,
    ``observe_dict`` and ``compose_rgb`` against their plain versions, bit
    for bit, on 300-step flagship trajectories (B = 4096, 1001, 1) and
    hand-built stacks; ``render_rgb84`` still bit-equal; the flagship grouped
    engine equal to the turbo grouped engine through ``from_flagship``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, grouped, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb_plain, feature_vector_plain
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(26)
    cfg = EngineConfig(auto_reset=True)
    P = engine.PIECES
    checked = {"grouped_flagship": 0, "feature_vector": 0, "observe_dict": 0, "compose_rgb": 0,
               "render_rgb84": 0}

    def check_state(s, what, grouped_too, all_flags, forced):
        d = kernels.observe_dict(s, cfg, P)
        dp = engine.observe_dict_plain(s, cfg)
        for k in dp:
            diff("observe_dict", d[k], dp[k], f"{what} {k}")
        compose_builds_diff(d["board"], d["queue"], d["holder"], P, 1,
                            compose_rgb_plain(dp["board"], dp["queue"], dp["holder"], P), f"{what} rgb", forced)
        diff("render_rgb84", kernels.render_rgb84(s, cfg, P), engine.render_rgb84_plain(s, cfg),
             f"{what} rgb84")
        strips = kernels.observe_dict(s, cfg, P, strips_only=True)
        if strips.keys() != {"queue", "holder"}:
            raise AssertionError(f"observe_dict strips_only wrote {sorted(strips)}")
        for k in strips:
            diff("observe_dict", strips[k], dp[k], f"{what} strips_only {k}")
        crop = s.board[:, :20, 4:14]
        for flags in (FLAG_SETS if all_flags else (tuple(FeatureFlags()),)):
            feature_builds_diff(crop, FeatureFlags(*flags), feature_vector_plain(crop, FeatureFlags(*flags)),
                                f"{what} features {flags}", forced)
        checked.update({k: checked[k] + 1 for k in ("observe_dict", "compose_rgb", "render_rgb84",
                                                    "feature_vector")})
        if not grouped_too:
            return
        want = grouped.placements_plain(s, cfg)
        for k, (a, b) in enumerate(zip(kernels.grouped_flagship(s, cfg, P, "ids"), want)):
            diff("grouped_flagship", a, b, f"{what} ids output {k}")
        diff("grouped_flagship", kernels.grouped_flagship(s, cfg, P, "boards")[0], want[0].float(),
             f"{what} boards")
        for flags in (FLAG_SETS[1:] if all_flags else (tuple(FeatureFlags()),)):
            diff("grouped_flagship", kernels.grouped_flagship(s, cfg, P, "features", FeatureFlags(*flags))[0],
                 _grouped_features_plain(want[0], FeatureFlags(*flags)), f"{what} features {flags}")
        B, A = want[1].shape
        rgb = grouped.grouped_observation(s, cfg, mode="rgb")[0]  # ids, observe_dict, compose_rgb
        grouped_rgb = compose_rgb_plain(want[0].view(torch.uint8).reshape(B * A, 24, 18), dp["queue"],
                                        dp["holder"], P, A)
        diff("compose_rgb", rgb, grouped_rgb.reshape(rgb.shape), f"{what} grouped rgb")
        if forced:
            compose_builds_diff(want[0].view(torch.uint8).reshape(B * A, 24, 18).contiguous(), d["queue"],
                                d["holder"], P, A, grouped_rgb, f"{what} grouped rgb")
        checked["grouped_flagship"] += 1
        return want

    t0 = time.perf_counter()
    runs, n_illegal, n_over = [], 0, 0
    for B in SURFACE_B:
        s = kernels.flagship_init(batch_keys(prng_key(26 + B), B, device=dev), cfg, P)
        n_done = 0
        for i in range(SURFACE_STEPS + 1):
            want = check_state(s, f"B={B} @ {i}", i % SURFACE_GROUPED_EVERY == 0,
                               i % SURFACE_FLAGS_EVERY == 0, i % SURFACE_FORCED_EVERY == 0)
            if want is not None:
                n_illegal += int((want[1] == 0).sum())
                n_over += int(want[2].sum())
            if i == SURFACE_STEPS:
                break
            s, _, kd, _ = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P,
                                                RewardsMapping())
            n_done += int(kd.sum())
        runs.append({"B": B, "steps": SURFACE_STEPS, "episodes_ended": n_done})
    # hand-built stacks: garbage ids, up to six full rows, random poses, a
    # full holder, and a quarter of the envs stacked to the ceiling
    s = kernels.flagship_init(batch_keys(prng_key(27), 4096, device=dev), cfg, P)
    s, _ = _surgery_boards(s, g, dev)
    board = s.board.clone()
    board[:1024, :8, 4:14] = torch.randint(2, 9, (1024, 8, 10), generator=g, device=dev,
                                           dtype=torch.int8)
    s = s.replace(board=board,
                  holder_count=torch.randint(0, 2, (4096,), generator=g, device=dev, dtype=torch.int32),
                  holder_piece=torch.randint(0, 7, (4096, 1), generator=g, device=dev, dtype=torch.int32))
    want = check_state(s, "surgery", True, True, True)
    play = s.board[:1001, :20, 4:14].contiguous()  # 1001 x 200 bytes end inside a 16-byte word
    if kernels._feature_words(play):
        raise AssertionError("an unpadded crop of 1001 envs took the words build")
    diff("feature_vector", kernels.feature_vector(play, FeatureFlags()), feature_vector_plain(play),
         "surgery unpadded crop")
    if int(want[3].max()) < 2 or not bool(want[2].any()) or not bool((want[1] == 0).any()):
        raise AssertionError("the hand-built stacks made no multi-line, game-over or illegal candidate")
    if n_illegal == 0 or n_over == 0:
        raise AssertionError(f"the trajectories made no illegal ({n_illegal}) or game-over ({n_over}) "
                             "candidate")

    # the flagship grouped engine plays the turbo grouped engine's game
    gcfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    keys = batch_keys(prng_key(26), GROUPED_ENGINE_B, device=dev)
    fgs, fobs = grouped.reset(keys, gcfg, mode="features", device=dev)
    tgs, tobs = tg.reset(keys, gcfg, device=dev)
    lines = 0
    for i in range(SURFACE_TURBO_STEPS + 1):
        if not (torch.equal(bits(fobs), bits(tobs)) and torch.equal(fgs.mask.T, tgs.mask)):
            raise AssertionError(f"flagship and turbo grouped observations differ @ {i}")
        ft = turbo.from_flagship(fgs.env, gcfg)
        for k in turbo.FIELDS:
            if not torch.equal(bits(getattr(ft, k)), bits(getattr(tgs.env, k))):
                raise AssertionError(f"flagship and turbo grouped {k} differ @ {i}")
        if i == SURFACE_TURBO_STEPS:
            break
        a = _surface_actions(fgs.mask, g, dev, 0.1)
        fgs, fobs, fr, fd, fi = grouped.step(fgs, a, gcfg, mode="features")
        tgs, tobs, tr, td, ti = tg.step(tgs, a, gcfg)
        for got, ref, what in ((fr, tr, "reward"), (fd, td, "done"),
                               (fi["lines_cleared"], ti["lines_cleared"], "lines")):
            if not torch.equal(bits(got), bits(ref)):
                raise AssertionError(f"flagship and turbo grouped {what} differ @ {i}")
        lines += int(fi["lines_cleared"].sum())
    torch.cuda.synchronize()
    keys_ = ("grouped_flagship", "feature_vector", "observe_dict", "compose_rgb", "render_rgb84")
    emit({"phase": "surface_kernels", "bit_equal": True, "turbo_grouped_equal": True, "runs": runs,
          "checked_states": checked, "illegal_candidates": n_illegal, "game_over_candidates": n_over,
          "turbo_steps": SURFACE_TURBO_STEPS, "turbo_lines": lines,
          "max_abs_err": {k: MAX_ERR[k] for k in keys_}, "seconds": time.perf_counter() - t0})
    return checked


def _eq_obs(a, b, what):
    """Two host observations (arrays or dicts of arrays) are equal."""
    a, b = (a, b) if isinstance(b, dict) else ({0: a}, {0: b})
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: keys {sorted(a)} vs {sorted(b)}")
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {k} differs between card and CPU")


def _wrapper_launches(mode, terminate, legal, A):
    """Launches of one grouped wrapper step (``legal`` None: its reset),
    and of ``feature_vector`` and ``compose_rgb`` by batch (``"name@B"``):
    the env's own observation at B = 1, the ``A`` candidates' at B = A (the
    rgb mode's composites with ``group`` = A)."""
    out = {}

    def add(**kw):
        for k, v in kw.items():
            out[k] = out.get(k, 0) + v

    info_fn = {"features": "feature_vector", "rgb": "compose_rgb", "host": "feature_vector"}.get(mode)
    if legal is None:
        add(flagship_init=1, observe_dict=1, grouped_flagship=1)
    else:
        add(flagship_step=1 if terminate else 2, grouped_flagship=1)
    if mode == "rgb":
        add(observe_dict=1, compose_rgb=1, **{f"compose_rgb@{A}": 1})
    if legal is None or legal:
        if legal:
            add(observe_dict=1)
        if info_fn:
            add(**{info_fn: 1, f"{info_fn}@1": 1})
    if mode == "host" and (legal is None or legal or not terminate):
        if legal is False:
            add(observe_dict=1)
        add(feature_vector=1, **{f"feature_vector@{A}": 1})  # the A candidates' boards in one call
    return out


def check_shell(dev, geometry=None) -> dict:
    """Phase 27 (the default board) and 37 (``geometry``, the keywords of
    ``Tetris``' width and height): ``Tetris(device="cuda")`` against
    ``Tetris(device="cpu")`` over 20 seeded episodes of random actions
    (out-of-range ids included), ``GroupedActionsObservations`` over
    ``Tetris`` in the features, boards, rgb and host modes, and
    ``RgbObservation`` and ``FeatureVectorObservation``, card against CPU,
    with exact launch counts a step, and one shell step's host ms.  Returns
    the launches of the card's runs, all together and each run's
    (``runs``: the shell, each wrapper mode, each observation wrapper,
    with ``feature_vector``'s and ``compose_rgb``'s launches by batch)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.envs import Tetris
    from tetris_gymnasium_torch.wrappers import (FeatureVectorObservation, GroupedActionsObservations,
                                                 RgbObservation)

    geo = geometry or {}
    rng = np.random.default_rng(27)
    t0 = time.perf_counter()
    card = Tetris(render_mode="rgb_array", device=dev, **geo)
    cpu = Tetris(render_mode="rgb_array", device="cpu", **geo)
    n_actions = card.config.width * 4
    kernels.reset_launches()
    steps = ends = lines = 0
    for ep in range(SHELL_EPISODES):
        oc, _ = card.reset(seed=ep)
        op, _ = cpu.reset(seed=ep)
        _eq_obs(oc, op, f"episode {ep} reset")
        for t in range(SHELL_MAX_STEPS):
            a = int(rng.choice(SHELL_ACTIONS, p=SHELL_ACTION_P))
            oc, rc, tc, trc, ic = card.step(a)
            op, rp, tp, trp, ip = cpu.step(a)
            _eq_obs(oc, op, f"episode {ep} step {t}")
            if (rc, tc, trc, ic) != (rp, tp, trp, ip):
                raise AssertionError(f"episode {ep} step {t}: {(rc, tc, trc, ic)} vs {(rp, tp, trp, ip)}")
            _eq_obs(card.render(), cpu.render(), f"episode {ep} step {t} rgb_array")
            if card._render_ansi() != cpu._render_ansi():
                raise AssertionError(f"episode {ep} step {t}: ansi renders differ")
            steps += 1
            lines += ic["lines_cleared"]
            if tc:
                ends += 1
                break
    torch.cuda.synchronize()
    shell_launches, shell_batches = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BY_BATCH)
    resets = SHELL_EPISODES
    want = {**{k: 0 for k in shell_launches}, "flagship_init": resets, "flagship_step": steps,
            "observe_dict": resets + 3 * steps, "compose_rgb": steps}
    if shell_launches != want or shell_batches != {"compose_rgb@1": steps}:
        raise AssertionError(f"shell launch counts {shell_launches} {shell_batches}, want {want} "
                             f"and compose_rgb@1 {steps}")
    if ends == 0:
        raise AssertionError("no shell episode ended")
    shell_seconds = time.perf_counter() - t0

    # the grouped wrapper over the shell, every mode
    t1 = time.perf_counter()
    A = card.config.width * 4  # the candidates of a grouped step
    runs = [{"path": "shell", "steps": steps, "launches": shell_launches, "batches": shell_batches}]
    wrapper_runs = []
    total = {k: 0 for k in kernels.LAUNCHES}
    for mode, terminate in (("features", True), ("boards", True), ("rgb", True), ("host", True),
                            ("features", False)):
        stacks = []
        for where in (dev, "cpu"):
            env = Tetris(gravity=False, device=where, **geo)
            inner = {"features": [FeatureVectorObservation(env)], "boards": None,
                     "rgb": [RgbObservation(env)],
                     "host": [FeatureVectorObservation(env, report_bumpiness=False)]}[mode]
            stacks.append(GroupedActionsObservations(env, inner, terminate, "host" if mode == "host" else None))
        w, wp = stacks
        kernels.reset_launches()
        want = {k: 0 for k in kernels.LAUNCHES}
        batches = {}
        n_steps = n_illegal = 0

        def expect(legal):
            for k, v in _wrapper_launches(mode, terminate, legal, A).items():
                (batches if "@" in k else want)[k] = (batches if "@" in k else want).get(k, 0) + v

        for ep in range(WRAPPER_EPISODES):
            o, i = w.reset(seed=100 + ep)
            op, ip = wp.reset(seed=100 + ep)
            expect(None)
            for t in range(WRAPPER_MAX_STEPS):
                _eq_obs(o, op, f"{mode} episode {ep} step {t} obs")
                if i.keys() != ip.keys():
                    raise AssertionError(f"{mode} episode {ep} step {t}: info keys differ")
                for k in ip:
                    _eq_obs(i[k], ip[k], f"{mode} episode {ep} step {t} info {k}")
                legal, illegal = (np.nonzero(i["action_mask"] == v)[0] for v in (1, 0))
                u = rng.random()
                pick = illegal if (u < 0.05 and len(illegal)) or not len(legal) else legal
                a = int(rng.integers(0, n_actions)) if u > 0.95 else int(rng.choice(pick))
                is_legal = bool(i["action_mask"][a])
                expect(is_legal)
                o, r, d, tr, i = w.step(a)
                op, rp, dp, trp, ip = wp.step(a)
                if (r, d, tr) != (rp, dp, trp):
                    raise AssertionError(f"{mode} episode {ep} step {t}: {(r, d, tr)} vs {(rp, dp, trp)}")
                n_steps += 1
                n_illegal += int(not is_legal)
                if d:
                    break
        torch.cuda.synchronize()
        got, got_batches = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BY_BATCH)
        if got != want or got_batches != batches:
            raise AssertionError(f"grouped wrapper ({mode}, terminate={terminate}) launches {got} "
                                 f"{got_batches}, want {want} {batches}")
        if n_illegal == 0:
            raise AssertionError(f"grouped wrapper ({mode}) took no illegal action")
        for k in total:
            total[k] += got[k]
        wrapper_runs.append({"mode": mode, "terminate_on_illegal": terminate, "steps": n_steps,
                             "illegal": n_illegal, "launches": {k: v for k, v in got.items() if v},
                             "batches": got_batches})
        runs.append({"path": f"wrapper_{mode}" + ("" if terminate else "_noterm"), "steps": n_steps,
                     "launches": got, "batches": got_batches})
    launches = {k: shell_launches[k] + total[k] for k in total}
    extra = _observation_wrappers_card_cpu(dev, geo, rng)
    for name in ("rgb", "features"):  # features_flags: checks of more flag sets, no path
        run = extra["observation_wrappers"][name]
        runs.append({"path": f"{name}_observation", "steps": run["steps"],
                     "launches": {k: run["launches"].get(k, 0) for k in kernels.LAUNCHES},
                     "batches": run["batches"]})
    emit({"phase": "shell" if geometry is None else "wide_shell", **geo, "equal_card_cpu": True,
          "episodes": SHELL_EPISODES, "steps": steps, "episodes_ended": ends, "lines": lines,
          "launches": {k: v for k, v in shell_launches.items() if v},
          "launches_per_step": {k: v / steps for k, v in shell_launches.items() if v},
          "shell_seconds": shell_seconds, "grouped_wrapper": wrapper_runs,
          "wrapper_seconds": time.perf_counter() - t1, **extra})
    return {"launches": launches, "steps": steps + sum(r["steps"] for r in wrapper_runs), "runs": runs, **extra}


def _observation_wrappers_card_cpu(dev, geo, rng) -> dict:
    """Phases 27 and 37's ``RgbObservation`` and ``FeatureVectorObservation``
    over ``Tetris(**geo)``, card against CPU, each alone with exact launch
    counts a step, those of its kernel by batch too (the path's run); then
    ``FeatureVectorObservation`` under two more flag sets over the lead
    wrapper's steps (a run of checks, not a path); and one shell step's
    host ms on the card."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.envs import Tetris
    from tetris_gymnasium_torch.wrappers import FeatureVectorObservation, RgbObservation

    flag_sets = ((1, 1, 1, 1), (0, 1, 1, 0), (1, 0, 0, 1))
    resets = WRAPPER_EPISODES
    runs = {}
    for name in ("rgb", "features", "features_flags"):
        pair = []
        for where in (dev, "cpu"):
            env = Tetris(device=where, **geo)
            pair.append([RgbObservation(env)] if name == "rgb"
                        else [FeatureVectorObservation(env, *f) for f in flag_sets[: 1 if name == "features" else 3]])
        (lead, *others), (lead_p, *others_p) = pair
        kernels.reset_launches()
        n = 0
        for ep in range(WRAPPER_EPISODES):
            o, _ = lead.reset(seed=200 + ep)
            op, _ = lead_p.reset(seed=200 + ep)
            for t in range(WRAPPER_MAX_STEPS):
                _eq_obs(o, op, f"{type(lead).__name__} episode {ep} step {t}")
                for f, fp in zip(others, others_p):
                    _eq_obs(f.observation(None), fp.observation(None),
                            f"FeatureVectorObservation {f.flags} episode {ep} step {t}")
                a = int(rng.choice(8, p=np.asarray(FLAGSHIP_ACTION_P)))
                o, r, d, *_ = lead.step(a)
                op, rp, dp, *_ = lead_p.step(a)
                if (r, d) != (rp, dp):
                    raise AssertionError(f"{name} wrapper episode {ep} step {t}: {(r, d)} vs {(rp, dp)}")
                n += 1
                if d:
                    break
        torch.cuda.synchronize()
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        batches = dict(kernels.LAUNCHES_BY_BATCH)
        # a step: flagship_step, the env's observe_dict and the wrapper's
        # kernel at B = 1; the other flag sets checked by hand: one
        # feature_vector each a step
        kernel = "compose_rgb" if name == "rgb" else "feature_vector"
        want = {"flagship_init": resets, "flagship_step": n, "observe_dict": resets + n,
                kernel: resets + n + len(others) * n}
        if got != want or batches != {f"{kernel}@1": want[kernel]}:
            raise AssertionError(f"{name} observation wrapper launches {got} {batches}, want {want} at B = 1")
        runs[name] = {"steps": n, "launches": got, "batches": batches}
    env = Tetris(device=dev, **geo)
    env.reset(seed=0)
    acts = rng.choice(8, SHELL_TIMED_STEPS, p=np.asarray(FLAGSHIP_ACTION_P))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        if env.step(int(a))[2]:
            env.reset(seed=int(a))
    return {"observation_wrappers": runs,
            "shell_step_call_ms": 1e3 * (time.perf_counter() - t0) / SHELL_TIMED_STEPS}


def run_grouped_engine(dev, smi) -> dict:
    """Phase 28: the batched flagship grouped engine at 4096 envs, 32 steps of
    random legal placements in features and in boards mode; placements/s on
    the host's clock, the step's parts with CUDA events."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, grouped
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(28)
    cfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    B, T = GROUPED_ENGINE_B, GROUPED_ENGINE_STEPS
    out = {}
    total = {k: 0 for k in kernels.LAUNCHES}
    for mode in ("features", "boards"):
        gs, _ = grouped.reset(batch_keys(prng_key(28), B, device=dev), cfg, mode=mode, device=dev)
        actions = [None] * T
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(T):
            actions[i] = _surface_actions(gs.mask, g, dev, 0.0)
            gs, obs, r, d, info = grouped.step(gs, actions[i], cfg, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        want = {**{k: 0 for k in got}, "flagship_step": T, "flagship_init": T, "grouped_flagship": T}
        if got != want:
            raise AssertionError(f"grouped engine ({mode}) launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
        if not torch.isfinite(obs).all() or obs.shape[:2] != (B, 40):
            raise AssertionError(f"grouped engine ({mode}) observation {tuple(obs.shape)} not finite")
        held = grouped_flagship_diff(gs.env, cfg, engine.PIECES, f"phase 28 {mode} final state")
        a = actions[-1]
        drop_a = torch.full_like(a, 5)
        parts = {
            "grouped_flagship": device_ms(lambda: kernels.grouped_flagship(gs.env, cfg, engine.PIECES, mode), 20),
            "hard_drop": device_ms(lambda: kernels.flagship_step(gs.env, drop_a, cfg, engine.PIECES,
                                                                 RewardsMapping()), 20),
            "auto_reset_init": device_ms(lambda: kernels.flagship_init(gs.env.key.T.contiguous(), cfg,
                                                                       engine.PIECES), 20),
        }
        step_call = call_ms(lambda: grouped.step(gs, a, cfg, mode=mode), 20)
        parts["selects_and_rest_call"] = step_call - sum(parts.values())
        out[mode] = {"B": B, "steps": T, "wall_s": wall, "step_ms": 1e3 * wall / T,
                     "placements_per_s": B * T / wall, "candidates_per_s": 40 * B * T / wall,
                     "step_call_ms": step_call, "parts_device_ms": parts, "bit_equal": held}
        emit({"phase": "grouped_engine", "mode": mode, **out[mode], "launches": want, "nvidia_smi": smi})
    return {"launches": total, "steps": 2 * T, "times": out}


def run_vector_env(dev, smi, geometry=None) -> dict:
    """Phase 29 (the default board) and 33 (``geometry``, the keywords of an
    ``EngineConfig``): ``TetrisVectorEnv`` at 8192 envs x 64 steps, numpy in
    and out, ``impl="turbo"`` and ``"flagship"``; the first 16 steps (mostly
    hard drops, so that episodes end in them) equal to a CPU run at the same
    B and seed, ``final_obs`` included."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.envs import TetrisVectorEnv
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    config = EngineConfig(**(geometry or {}))
    rng = np.random.default_rng(29)
    B, T = VECTOR_B, VECTOR_STEPS
    p = np.asarray(FLAGSHIP_ACTION_P)
    out = {}
    total = {k: 0 for k in kernels.LAUNCHES}
    keys = batch_keys(prng_key(29), B, device=dev)  # flagship_init at the path's shape
    _fields_diff("flagship_init", kernels.flagship_init(keys, config, engine.PIECES),
                 engine.init_plain(keys, config, engine.PIECES), engine.FIELDS,
                 f"vector env {config.width}x{config.height} init B={B}")
    for impl in ("turbo", "flagship"):
        acts = [rng.choice(8, B, p=VECTOR_DROP_P if t < VECTOR_CHECK_STEPS else p) for t in range(T)]
        cpu = TetrisVectorEnv(B, config, impl=impl, seed=29, device="cpu")
        ref = [cpu.reset(seed=29)] + [cpu.step(a) for a in acts[:VECTOR_CHECK_STEPS]]
        env = TetrisVectorEnv(B, config, impl=impl, seed=29, device=dev)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [env.reset(seed=29)]
        ends = 0
        for t in range(T):
            res = env.step(acts[t])
            ends += int(res[2].sum())
            if t < VECTOR_CHECK_STEPS:
                got.append(res)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        names = {"turbo": ("turbo_init", "turbo_step", "observe_board"),
                 "flagship": ("flagship_init", "flagship_step", "flagship_observe_board")}[impl]
        want = {**{k: 0 for k in launches}, names[0]: T + 1, names[1]: T, names[2]: 2 * T + 1}
        if launches != want:
            raise AssertionError(f"vector env ({impl}) launches {launches}, want {want}")
        for t, (g_, r_) in enumerate(zip(got, ref)):
            for k, (x, y) in enumerate(zip(g_[:-1], r_[:-1])):
                if not np.array_equal(x, y) or x.dtype != y.dtype:
                    raise AssertionError(f"vector env ({impl}) output {k} @ {t} differs from the CPU's")
            gi, ri = g_[-1], r_[-1]
            if gi.keys() != ri.keys():
                raise AssertionError(f"vector env ({impl}) info keys @ {t} differ")
            for k in ri:
                for x, y in zip(gi[k], ri[k]) if ri[k].dtype == object else [(gi[k], ri[k])]:
                    if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
                        raise AssertionError(f"vector env ({impl}) info {k} @ {t} differs from the CPU's")
        checked_ends = sum(int(r[2].sum()) for r in ref[1:])
        if checked_ends == 0:
            raise AssertionError(f"vector env ({impl}): no episode ended in the steps checked")
        out[impl] = {"B": B, "steps": T, "wall_s": wall, "step_ms": 1e3 * wall / T,
                     "env_steps_per_s": B * T / wall, "episodes_ended": ends,
                     "checked_steps": VECTOR_CHECK_STEPS, "checked_episode_ends": checked_ends}
        for k in total:
            total[k] += launches[k]
        emit({"phase": "vector_env" if geometry is None else "wide_vector_env", "impl": impl,
              "width": config.width, "height": config.height, **out[impl], "equal_cpu": True,
              "launches": {k: v for k, v in launches.items() if v}, "nvidia_smi": smi})
    return {"launches": total, "steps": 2 * T, "times": out}


def time_surface_kernels(dev, smi) -> dict:
    """Phase 30: the four new kernels' device ms at B = 1, 4096 and 65536
    (the grouped boards mode at 4096) beside their bounds and their plain
    versions (at most at B = 4096, scaled), ``compose_rgb`` beside its
    yardstick, ``feature_vector`` and ``compose_rgb`` at the grouped
    wrapper's 40 candidates too, and one shell step's host ms at B = 1."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, grouped
    from tetris_gymnasium_torch.envs import Tetris
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb_plain, feature_vector_plain
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(30)
    cfg = EngineConfig(auto_reset=True)
    P = engine.PIECES
    flags = FeatureFlags()
    out = {k: {} for k in ("grouped_flagship", "feature_vector", "observe_dict", "compose_rgb")}
    for B in SURFACE_TIME_B:
        big = B >= 65536
        s = kernels.flagship_init(batch_keys(prng_key(30 + B), B, device=dev), cfg, P)
        for _ in range(40):  # mid-game boards
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, RewardsMapping())[0]
        pb = min(B, SURFACE_PLAIN_MAX_B)
        ps = engine.EngineState(**{k: (getattr(s, k)[:, :pb] if k == "key" else getattr(s, k)[:pb])
                                   .contiguous() for k in engine.FIELDS})
        scale = B / pb
        d = kernels.observe_dict(s, cfg, P)
        dp = {k: v[:pb].contiguous() for k, v in d.items()}
        crop, pcrop = s.board[:, :20, 4:14], ps.board[:, :20, 4:14]
        state_in = nbytes(s.board, s.piece, s.rotation)
        held = grouped_flagship_diff(s, cfg, P, f"phase 30 B={B}", n=pb)
        lines = kernels.grouped_flagship(s, cfg, P, "ids")[3]
        entries = {
            ("grouped_flagship", "features"): (
                lambda: kernels.grouped_flagship(s, cfg, P, "features"),
                lambda: _grouped_features_plain(grouped.placements_plain(ps, cfg)[0], flags),
                state_in + B * 40 * (13 * 4 + 4 + 1 + 4), grouped_flagship_ops(cfg, P, "features", lines)),
            ("feature_vector", None): (
                lambda: kernels.feature_vector(crop, flags), lambda: feature_vector_plain(pcrop, flags),
                B * (200 + 13 * 4), B * FEATURE_VECTOR_OPS_PER_ENV),
            ("observe_dict", None): (
                lambda: kernels.observe_dict(s, cfg, P), lambda: engine.observe_dict_plain(ps, cfg),
                nbytes(s.board, s.piece, s.rotation, s.x, s.y, s.queue, s.holder_piece, s.holder_rotation,
                       s.holder_count) + B * (2 * 432 + 16 + 64), B * OBSERVE_DICT_OPS_PER_ENV),
            ("compose_rgb", None): (
                lambda: kernels.compose_rgb(d["board"], d["queue"], d["holder"], P),
                lambda: compose_rgb_plain(dp["board"], dp["queue"], dp["holder"], P),
                B * (432 + 80 + 24 * 34 * 3), B * 24 * 34 * COMPOSE_OPS_PER_PIXEL),
        }
        for mode, cell in (("boards", 4), ("ids", 1)):  # both board modes at every B
            entries[("grouped_flagship", mode)] = (
                lambda m=mode: kernels.grouped_flagship(s, cfg, P, m),
                lambda m=mode: grouped.placements_plain(ps, cfg)[0].to(torch.float32 if m == "boards" else torch.int8),
                state_in + B * 40 * (432 * cell + 4 + 1 + 4), grouped_flagship_ops(cfg, P, mode, lines))
        for (name, mode), (kernel_fn, plain_fn, io, ops) in entries.items():
            entry = timed_pair(kernel_fn, plain_fn, 10 if big else 100, 1 if pb >= 4096 else 10, io, ops)
            entry.update(plain_ms=entry["plain_ms"] * scale, plain_B=pb, library_ms=None,
                         envs_per_s=B / (entry["ms"] * 1e-3))
            if name == "compose_rgb":
                entry.update(library_ms=compose_library_ms(d["board"], d["queue"], d["holder"], 1, P,
                                                           10 if big else 100),
                             library_call="palette_ext[id_image], given the composed int64 id image")
            if name == "grouped_flagship":
                entry.update(held)
            out[name][f"{mode}@{B}" if mode else B] = entry
        del s, ps, d, dp
        torch.cuda.empty_cache()
    # the grouped wrapper's 40 candidates: the host mode's boards, the rgb mode's composites
    for k, by_b in wrapper_kernel_times(dev, cfg, P, (SURFACE_CANDIDATES,), 30).items():
        out[k].update(by_b)
    # one shell step at B = 1, host clock
    env = Tetris(device=dev)
    env.reset(seed=0)
    rng = np.random.default_rng(30)
    acts = rng.choice(8, SHELL_TIMED_STEPS, p=np.asarray(FLAGSHIP_ACTION_P))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        if env.step(int(a))[2]:
            env.reset(seed=int(a))
    shell_ms = 1e3 * (time.perf_counter() - t0) / SHELL_TIMED_STEPS
    out["shell_step_call_ms"] = shell_ms
    emit({"phase": "surface_times", **out, "nvidia_smi": smi})
    return out


# ---------------------------------------------------------------------------
# 31.-34. wide boards and other geometries
# ---------------------------------------------------------------------------

WIDE_B = (4096, 1001, 1)
WIDE_STEPS = 300
WIDE_GAPS = (0, 12, 14, 26)  # tests/test_wide_boards.py:118-157: 12..15 and 14..17 straddle words
WIDE_CROSS_B, WIDE_CROSS_STEPS = 4096, 120
WIDE_TIME_B = (4096, 65536)
WIDE_TIMED = ("30x20", "61x12")
WIDE_PLAIN_MAX_B = 4096  # the plain versions' batch in phase 34; larger B scaled from it
WIDE_VECTOR = dict(width=30, height=20)  # phase 33, the slice's path


def wide_geometries():
    """``(name, config, pieces)`` of every geometry of the JAX package's
    wide-board and oversize-piece tests (tests/test_wide_boards.py:31-37,
    tests/test_components.py:221-330): padded widths 38, 69 and 36 (bit 31
    of word 0 in play), a narrow 8x12 board with a queue of 2, and the 6x6
    pieces, whose table entries take two words, at widths 10 and 30."""
    from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.pieces import PIECES

    big, pad = pieces_from_tetrominoes([
        Tetromino(2, (255, 0, 0), np.array([[1, 1], [1, 1]], np.uint8)),
        Tetromino(3, (0, 255, 0), np.ones((1, 6), np.uint8)),
        Tetromino(4, (0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))])
    oversize = dict(height=16, padding=pad, queue_size=2, queue_kind="uniform", auto_reset=True)
    return [
        ("30x20", EngineConfig(width=30, height=20, auto_reset=True), PIECES),
        ("30x20-nograv", EngineConfig(width=30, height=20, gravity_enabled=False), PIECES),
        ("61x12", EngineConfig(width=61, height=12, queue_size=3, auto_reset=True), PIECES),
        ("28x14", EngineConfig(width=28, height=14, auto_reset=True), PIECES),
        ("8x12-uniform", EngineConfig(width=8, height=12, queue_size=2, queue_kind="uniform",
                                      auto_reset=True), PIECES),
        ("6x6-w10", EngineConfig(width=10, **oversize), big),
        ("6x6-w30", EngineConfig(width=30, **oversize), big),
    ]


def _cat_turbo(states):
    from tetris_gymnasium_torch.core import turbo

    return turbo.TurboState(**{k: torch.cat([getattr(s, k) for s in states], dim=-1)
                               for k in turbo.FIELDS})


def _cat_flagship(states):
    from tetris_gymnasium_torch.core import engine

    return engine.EngineState(**{k: torch.cat([getattr(s, k) for s in states], dim=1 if k == "key" else 0)
                                 for k in engine.FIELDS})


def _graphed(fn, *example):
    """``fn`` captured once in a CUDA graph at the shapes of ``example``
    (tensors and state dataclasses): a call copies its arguments into the
    graph's inputs and replays it, and returns the graph's own outputs, valid
    until the next call.  The plain versions are sync-free, so phase 31 runs
    them this way and the host enqueues one replay, not hundreds of small
    kernels, a step."""
    import dataclasses

    def leaves(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)] if dataclasses.is_dataclass(x) else [x]

    static = [x.replace(**{f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)})
              if dataclasses.is_dataclass(x) else x.clone() for x in example]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def call(*args):
        for st, arg in zip(static, args):
            for dst, src in zip(leaves(st), leaves(arg)):
                dst.copy_(src)
        graph.replay()
        return out

    return call


def _fields_diff(kernel, ks, ps, fields, what):
    for k in fields:
        diff(kernel, getattr(ks, k), getattr(ps, k), f"{what}: {k}")


def _wide_stacks(cfg, pieces, B, g, dev, seed):
    """Flagship states on hand-built stacks: random cells below the top third,
    0..6 full rows at the bottom, a random piece at a random window."""
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    s = engine.init_plain(batch_keys(prng_key(seed), B, device=dev), cfg, pieces)
    H, W, pad = cfg.height, cfg.width, cfg.padding
    inner = torch.where(torch.rand((B, H, W), generator=g, device=dev) < 0.6, 3, 0).to(torch.int8)
    inner[:, : H // 3] = 0
    n_full = torch.randint(0, 7, (B,), generator=g, device=dev)
    full = torch.arange(H, device=dev)[None, :, None] >= H - n_full[:, None, None]
    board = s.board.clone()
    board[:, :H, pad : pad + W] = torch.where(full, 2, inner).to(torch.int8)
    n = int(pieces.ids.shape[0])
    return s.replace(
        board=board,
        piece=torch.randint(0, n, (B,), generator=g, device=dev, dtype=torch.int32),
        rotation=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32),
        x=torch.randint(-3, cfg.padded_width, (B,), generator=g, device=dev, dtype=torch.int32),
        y=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32)), n_full


def _straddle_state(cfg, gap, n_rows, B, dev):
    """tests/test_wide_boards.py:_surgery_states at B envs: the bottom
    ``n_rows`` playfield rows full but for a 4-wide gap at ``gap``, a flat I
    parked over it."""
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    s = engine.init_plain(batch_keys(prng_key(7), B, device=dev), cfg)
    H, W, pad = cfg.height, cfg.width, cfg.padding
    board = s.board.clone()
    board[:, H - n_rows : H, pad : pad + W] = 2
    board[:, H - n_rows : H, pad + gap : pad + gap + 4] = 0
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    return s.replace(board=board, piece=zero, rotation=zero.clone(),
                     x=torch.full((B,), gap + pad, dtype=torch.int32, device=dev), y=zero.clone())


def check_wide_kernels(dev) -> dict:
    """Phase 31: ``turbo_init``, ``turbo_step``, ``observe_board``,
    ``heights``, ``flagship_init``, ``flagship_step`` and
    ``flagship_observe_board`` bit-equal to their plain versions at every
    geometry of :func:`wide_geometries`, on 300-step trajectories at B =
    4096, 1001 and 1 (the plain versions run once on the three batches side
    by side, replayed from CUDA graphs), then on hand-built stacks: drops
    into 4-wide gaps at columns
    0, 12, 14 and 26 of one and two rows at 30x20, and random stacks with up
    to six full rows at every geometry (``turbo_step`` with ``max_clear`` 4
    and the board's height)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(31)
    rw = RewardsMapping()
    t0 = time.perf_counter()
    runs = []
    for name, cfg, P in wide_geometries():
        keys = [batch_keys(prng_key(31 + B), B, device=dev) for B in WIDE_B]
        ts = [kernels.turbo_init(k, cfg, P) for k in keys]
        fs = [kernels.flagship_init(k, cfg, P) for k in keys]
        all_keys = torch.cat(keys)
        _fields_diff("turbo_init", _cat_turbo(ts), turbo.init_plain(all_keys, cfg, P), turbo.FIELDS,
                     f"{name} init")
        _fields_diff("flagship_init", _cat_flagship(fs), engine.init_plain(all_keys, cfg, P),
                     engine.FIELDS, f"{name} flagship init")
        init_edges_diff(dev, cfg, P, f"phase 31 {name} init")
        turbo_init_diff(dev, cfg, P, f"phase 31 {name} init")
        n_done = n_lines = n_flines = n_variants = n_fbuilds = 0
        t_all, f_all = _cat_turbo(ts), _cat_flagship(fs)
        a_all = torch.zeros((sum(WIDE_B),), dtype=torch.int32, device=dev)
        plain = {
            "obs": _graphed(lambda t: turbo.observe_board_plain(t, cfg, P), t_all),
            "heights": _graphed(lambda t: turbo.heights_plain(t, cfg), t_all),
            "flagship_obs": _graphed(lambda f: engine.observe_board_plain(f, cfg, P), f_all),
            "step": _graphed(lambda t, a: turbo.step_plain(t, a, cfg, P), t_all, a_all),
            "flagship_step": _graphed(lambda f, a: engine.step_plain(f, a, cfg, P), f_all, a_all),
        }
        for i in range(WIDE_STEPS):
            t_all, f_all = _cat_turbo(ts), _cat_flagship(fs)
            what = f"{name} @ {i}"
            diff("observe_board", torch.cat([kernels.observe_board(s, cfg, P) for s in ts]),
                 plain["obs"](t_all), f"{what} obs")
            diff("heights", torch.cat([kernels.heights(s, cfg) for s in ts], dim=1),
                 plain["heights"](t_all), f"{what} heights")
            diff("flagship_observe_board", torch.cat([kernels.flagship_observe_board(s, cfg, P) for s in fs]),
                 plain["flagship_obs"](f_all), f"{what} flagship obs")
            acts = [_flagship_actions(B, g, dev) for B in WIDE_B]
            a_all = torch.cat(acts)
            kt = [kernels.turbo_step(s, a, cfg, P, rw) for s, a in zip(ts, acts)]
            pt = plain["step"](t_all, a_all)
            _fields_diff("turbo_step", _cat_turbo([o[0] for o in kt]), pt[0], turbo.FIELDS, f"{what} step")
            pf = plain["flagship_step"](f_all, a_all)
            kf = flagship_builds_diff(list(zip(fs, acts)), cfg, P, rw, pf, f"{what} flagship step")
            n_fbuilds += len(kernels.FLAGSHIP_LANES)
            for j, out in ((1, "reward"), (2, "done"), (3, "lines")):
                diff("turbo_step", torch.cat([o[j] for o in kt]), pt[j], f"{what} {out}")
            # every lanes count, with and without the observation, on each batch
            pobs, off = plain["obs"](pt[0]), 0
            for s_, a_, B in zip(ts, acts, WIDE_B):
                cut = pt[0].replace(**{k: getattr(pt[0], k)[..., off:off + B]
                                       for k in turbo.FIELDS})
                n_variants += step_variants_diff(
                    s_, a_, cfg, P, rw, 4, (cut, *(x[off:off + B] for x in pt[1:])),
                    f"{what} B={B}", want_obs=pobs[off:off + B])
                off += B
            n_done += int((pt[2] & ~t_all.game_over).sum())
            n_lines += int(pt[3].sum())
            n_flines += int(pf[3].sum())
            ts, fs = [o[0] for o in kt], [o[0] for o in kf]
        del plain
        # hand-built stacks with up to six full rows
        s, n_full = _wide_stacks(cfg, P, WIDE_B[0], g, dev, seed=310)
        t = turbo.from_flagship(s, cfg)
        a = torch.where(torch.rand((WIDE_B[0],), generator=g, device=dev) < 0.5, 5,
                        torch.randint(0, 8, (WIDE_B[0],), generator=g, device=dev)).to(torch.int32)
        stack_lines = {}
        for max_clear in (4, cfg.height):
            pt1 = turbo.step_plain(t, a, cfg, P, max_clear=max_clear)
            n_variants += step_variants_diff(t, a, cfg, P, rw, max_clear, pt1,
                                             f"{name} stacks max_clear={max_clear}")
            stack_lines[f"turbo_max_clear_{max_clear}"] = int(pt1[3].max())
        diff("observe_board", kernels.observe_board(t, cfg, P), turbo.observe_board_plain(t, cfg, P),
             f"{name} stacks obs")
        diff("heights", kernels.heights(t, cfg), turbo.heights_plain(t, cfg), f"{name} stacks heights")
        pf1 = engine.step_plain(s, a, cfg, P)
        flagship_builds_diff([(s, a)], cfg, P, rw, pf1, f"{name} flagship stacks")
        n_fbuilds += len(kernels.FLAGSHIP_LANES)
        diff("flagship_observe_board", kernels.flagship_observe_board(s, cfg, P),
             engine.observe_board_plain(s, cfg, P), f"{name} flagship stacks obs")
        stack_lines["flagship"] = int(pf1[3].max())
        if stack_lines["flagship"] < 5:
            raise AssertionError(f"{name}: no hand-built stack cleared five rows at once")
        sampled = check_sample_builds(dev, cfg, P, name, 311)
        flagship_sampled = check_flagship_sample_builds(dev, cfg, P, name, 312, batches=WIDE_B,
                                                        steps=8)
        choices = observation_choices_diff(dev, cfg, P, f"phase 31 {name}", ("flagship_observe_board",))
        runs.append({"geometry": name, "config": cfg._asdict(), "pieces": int(P.ids.shape[0]),
                     "piece_side": int(P.matrices.shape[-1]), "steps": WIDE_STEPS, "B": list(WIDE_B),
                     "observe_board_choices": choices["flagship_observe_board"],
                     "episodes_ended": n_done, "lines": n_lines, "flagship_lines": n_flines,
                     "stacks_max_lines": stack_lines, "turbo_step_builds_compared": n_variants,
                     "flagship_step_builds_compared": n_fbuilds,
                     "sample": sampled, "flagship_sample": flagship_sampled})
        emit({"phase": "wide_kernels", **runs[-1], "seconds": time.perf_counter() - t0})
    # drops into gaps that straddle the word boundary, on both engines
    cfg = EngineConfig(width=30, height=20)
    clears = {}
    for gap in WIDE_GAPS:
        for n_rows in (1, 2):
            s = _straddle_state(cfg, gap, n_rows, WIDE_B[0], dev)
            t = turbo.from_flagship(s, cfg)
            a = torch.full((WIDE_B[0],), 5, dtype=torch.int32, device=dev)
            kt1, pt1 = kernels.turbo_step(t, a, cfg, turbo.PIECES, rw), turbo.step_plain(t, a, cfg)
            what = f"gap {gap} rows {n_rows}"
            pf1 = engine.step_plain(s, a, cfg)
            kf1 = flagship_builds_diff([(s, a)], cfg, engine.PIECES, rw, pf1, f"flagship {what}")[0]
            step_variants_diff(t, a, cfg, turbo.PIECES, rw, 4, pt1, what)
            _fields_diff("turbo_step", kt1[0], pt1[0], turbo.FIELDS, what)
            for j in (1, 2, 3):
                diff("turbo_step", kt1[j], pt1[j], f"{what} output {j}")
            _flagship_vs_turbo(kf1[0], kt1[0], what, cfg)
            if not (bool((pt1[3] == 1).all()) and bool((pf1[3] == 1).all())):
                raise AssertionError(f"{what}: the drop did not clear exactly one row")
            clears[f"{gap}x{n_rows}"] = 1
    torch.cuda.synchronize()
    out = {"bit_equal": True, "geometries": [r["geometry"] for r in runs], "straddling_clears": clears,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "wide_kernels_summary", **out,
          "max_abs_err": {k: MAX_ERR[k] for k in WIDE_KERNELS}})
    return out


WIDE_KERNELS = ("turbo_step", "turbo_init", "observe_board", "heights", "flagship_step",
                "flagship_init", "flagship_observe_board")


def check_wide_cross_engine(dev) -> dict:
    """Phase 32: the turbo engine equals the flagship engine on the card at
    30x20 and 61x12, 120 random steps at 4096 envs (kernels only): every
    field, occupancy from the id board, reward, done, lines and the board
    observation."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(32)
    out = {}
    for name, cfg, P in wide_geometries():
        if name not in WIDE_TIMED:
            continue
        keys = batch_keys(prng_key(32), WIDE_CROSS_B, device=dev)
        ts, fs = kernels.turbo_init(keys, cfg, P), kernels.flagship_init(keys, cfg, P)
        ends = lines = 0
        for i in range(WIDE_CROSS_STEPS):
            a = _flagship_actions(WIDE_CROSS_B, g, dev)
            ts, tr, td, tl = kernels.turbo_step(ts, a, cfg, P, RewardsMapping())
            fs, fr, fd, fl = kernels.flagship_step(fs, a, cfg, P, RewardsMapping())
            _flagship_vs_turbo(fs, ts, f"{name} step {i}", cfg)
            for x, y, what in ((tr, fr, "reward"), (td, fd, "done"), (tl, fl, "lines")):
                if not torch.equal(bits(x), bits(y)):
                    raise AssertionError(f"{name} step {i}: turbo {what} differs from the flagship's")
            if not torch.equal(kernels.observe_board(ts, cfg, P), kernels.flagship_observe_board(fs, cfg, P)):
                raise AssertionError(f"{name} step {i}: board observations differ")
            ends += int(td.sum())
            lines += int(tl.sum())
        out[name] = {"B": WIDE_CROSS_B, "steps": WIDE_CROSS_STEPS, "done": ends, "lines": lines}
    emit({"phase": "wide_cross_engine", "equal": True, **out})
    return out


def time_wide_kernels(dev, smi) -> dict:
    """Phase 34: device ms of every engine kernel at B = 4096 and 65536 at
    30x20 and 61x12, of ``turbo_step``, ``observe_board``,
    ``flagship_step`` and ``heights`` at the default geometry at 65536, and
    of the kernels of ``TetrisVectorEnv``'s two engines
    (``VECTOR_ENV_KERNELS``, phases 29 and 33) at its B = 8192 at the
    default geometry and 30x20, beside their bounds and their plain versions
    (at most at B = 4096, scaled), on mid-game states (40 random steps in)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(34)
    rw = RewardsMapping()
    geoms = [(n, c, p) for n, c, p in wide_geometries() if n in WIDE_TIMED]
    geoms.append(("default", EngineConfig(auto_reset=True), turbo.PIECES))
    out = {}
    for name, cfg, P in geoms:
        H, PW, S = cfg.padded_height, cfg.padded_width, int(P.matrices.shape[-1])
        nw, board = turbo.n_words(cfg), H * PW
        step_ops = 3 * board + 4 * (H - S + 1) * 2 * S * nw + cfg.height * cfg.height * nw
        for B in {"default": (VECTOR_B, 65536), "30x20": (4096, VECTOR_B, 65536)}.get(name, WIDE_TIME_B):
            big = B >= 65536
            keys = batch_keys(prng_key(34 + B), B, device=dev)
            t, f = kernels.turbo_init(keys, cfg, P), kernels.flagship_init(keys, cfg, P)
            _fields_diff("turbo_init", t, turbo.init_plain(keys, cfg, P), turbo.FIELDS,
                         f"phase 34 {name} turbo init B={B}")
            if B == VECTOR_B:
                _fields_diff("flagship_init", f, engine.init_plain(keys, cfg, P), engine.FIELDS,
                             f"phase 34 {name} init B={B}")
            for _ in range(40):
                a = _flagship_actions(B, g, dev)
                t = kernels.turbo_step(t, a, cfg, P, rw)[0]
                f = kernels.flagship_step(f, a, cfg, P, rw)[0]
            a = _flagship_actions(B, g, dev)
            pb = min(B, WIDE_PLAIN_MAX_B)
            pt = turbo.TurboState(**{k: getattr(t, k)[..., :pb].contiguous() for k in turbo.FIELDS})
            pf = engine.EngineState(**{k: (getattr(f, k)[:, :pb] if k == "key" else getattr(f, k)[:pb])
                                       .contiguous() for k in engine.FIELDS})
            tbytes = nbytes(*(getattr(t, k) for k in turbo.FIELDS))
            fbytes = nbytes(*(getattr(f, k) for k in engine.FIELDS))
            obs_out = B * cfg.height * cfg.width
            obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
            entries = {
                "turbo_step": (lambda: kernels.turbo_step(t, a, cfg, P, rw), lambda: turbo.step_plain(pt, a[:pb], cfg, P),
                               2 * tbytes + nbytes(a) + B * (4 + 1 + 4), 0),
                "turbo_step_obs": (lambda: kernels.turbo_step(t, a, cfg, P, rw, obs=obs),
                                   lambda: turbo.observe_board_plain(turbo.step_plain(pt, a[:pb], cfg, P)[0], cfg, P),
                                   2 * tbytes + nbytes(a) + B * (4 + 1 + 4) + obs_out, 0),
                "turbo_init": (lambda: kernels.turbo_init(keys, cfg, P), lambda: turbo.init_plain(keys[:pb], cfg, P),
                               nbytes(keys) + tbytes, 0),
                "observe_board": (lambda: kernels.observe_board(t, cfg, P),
                                  lambda: turbo.observe_board_plain(pt, cfg, P),
                                  nbytes(t.rows[: cfg.height], t.piece, t.rotation, t.x, t.y, t.game_over)
                                  + obs_out, 0),
                "heights": (lambda: kernels.heights(t, cfg), lambda: turbo.heights_plain(pt, cfg),
                            nbytes(t.rows[: cfg.height]) + B * cfg.width * 4, 0),
                "flagship_step": (lambda: kernels.flagship_step(f, a, cfg, P, rw),
                                  lambda: engine.step_plain(pf, a[:pb], cfg, P),
                                  2 * fbytes + nbytes(a) + B * (4 + 1 + 4), B * step_ops),
                "flagship_init": (lambda: kernels.flagship_init(keys, cfg, P),
                                  lambda: engine.init_plain(keys[:pb], cfg, P),
                                  nbytes(keys) + fbytes, B * (100 + board)),
                "flagship_observe_board": (lambda: kernels.flagship_observe_board(f, cfg, P),
                                           lambda: engine.observe_board_plain(pf, cfg, P),
                                           nbytes(_playfield(f.board, cfg), f.piece, f.rotation, f.x, f.y,
                                                  f.game_over) + obs_out,
                                           B * 6 * cfg.height * cfg.width),
            }
            if B == VECTOR_B:
                entries = {k: v for k, v in entries.items() if k in VECTOR_ENV_KERNELS}
            elif name == "default":
                entries = {k: v for k, v in entries.items()
                           if k in ("turbo_step", "turbo_step_obs", "observe_board", "flagship_step",
                                    "heights")}
            for kname, (kernel_fn, plain_fn, io, ops) in entries.items():
                entry = timed_pair(kernel_fn, plain_fn, 20 if big else 100, 2 if big else 10, io, ops)
                entry.update(plain_ms=entry["plain_ms"] * B / pb, plain_B=pb, library_ms=None,
                             envs_per_s=B / (entry["ms"] * 1e-3))
                out.setdefault(name, {}).setdefault(kname, {})[B] = entry
            out[name]["flagship_step"][B]["lanes"] = kernels.flagship_step_lanes(B, cfg.padded_height)
            if "flagship_init" in out[name] and B in out[name]["flagship_init"]:
                out[name]["flagship_init"][B]["shape"] = kernels.flagship_init_shape(cfg, P, B)
            if "turbo_init" in out[name] and B in out[name]["turbo_init"]:
                out[name]["turbo_init"][B]["shape"] = kernels.turbo_init_shape(cfg, P, B)
            out[name]["flagship_step"][B]["builds_ms"] = {
                lanes: device_ms(lambda: kernels.flagship_step(f, a, cfg, P, rw, lanes=lanes),
                                 20 if big else 100) for lanes in kernels.FLAGSHIP_LANES}
            emit({"phase": "wide_times", "geometry": name, "B": B, "words_per_row": nw,
                  "kernels": {k: v[B] for k, v in out[name].items() if B in v}, "nvidia_smi": smi})
            del t, f, pt, pf, obs
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 35.-39. the Gymnasium surface and both grouped engines at any geometry
# ---------------------------------------------------------------------------

SURF_GEO_B = (1001, 1)
SURF_GEO_STEPS = 200
SURF_GEO_GROUPED_EVERY = 25  # the grouped kernels against their plain versions every 25th state
GROUPED_WIDE = dict(width=30, height=14, gravity_enabled=False, auto_reset=True)  # tests/test_wide_boards.py:165-191
GROUPED_WIDE_B, GROUPED_WIDE_STEPS = 4096, 50
SHELL_WIDE = dict(width=30, height=20)  # phase 37, the slice's path
GROUPED_RATE_WIDE = dict(width=30, height=20, gravity_enabled=False, auto_reset=True)  # phase 38
SURF_WIDE_TIME_B = (4096, 65536)
SURF_WIDE_PLAIN_B = {"grouped": 1024, "other": 4096}  # the plain versions' batch; larger B scaled
SURFACE_KERNELS = ("grouped_flagship", "grouped_placements", "feature_vector", "observe_dict",
                   "compose_rgb", "render_rgb84")


def surface_geometries():
    """:func:`wide_geometries` and a holder longer than the queue (queue 1,
    holder 2: the sidebar is ``S * max(queue, holder)`` wide and the queue
    strip is widened with bedrock)."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.pieces import PIECES

    return wide_geometries() + [("queue1-holder2", EngineConfig(queue_size=1, holder_size=2,
                                                                auto_reset=True), PIECES)]


def _side(pieces) -> int:
    return int(pieces.matrices.shape[-1])


def _rgb84_taken(cfg, pieces) -> bool:
    """JAX's resize takes the composite: at most 84 pixels on each side."""
    S = _side(pieces)
    return max(cfg.padded_height, cfg.padded_width + S * max(cfg.queue_size, cfg.holder_size)) <= 84


def _grouped_features_of(boards, cfg, flags):
    """The features mode of the flagship grouped engine, from the plain
    placements' id boards."""
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, feature_vector_plain

    B, A = boards.shape[:2]
    pad = cfg.padding
    crop = boards[:, :, :-pad, pad:-pad].reshape(B * A, cfg.height, cfg.width)
    flags = FeatureFlags() if flags is None else flags
    return feature_vector_plain(crop, flags).reshape(B, A, -1).to(torch.float32)


def _check_grouped_surface(s, cfg, P, what, stacks=False) -> dict:
    """``grouped_flagship`` in its three modes and ``grouped_placements`` in
    both against their plain versions on the flagship state ``s`` (the
    turbo state through ``from_flagship``); with ``stacks`` the turbo
    engine's envelope at ``max_clear`` 4 and at the board's height."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import grouped, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.observations import FeatureFlags

    want = grouped.placements_plain(s, cfg, P)
    for k, (a, b) in enumerate(zip(kernels.grouped_flagship(s, cfg, P, "ids"), want)):
        diff("grouped_flagship", a, b, f"{what} ids output {k}")
    diff("grouped_flagship", kernels.grouped_flagship(s, cfg, P, "boards")[0], want[0].float(),
         f"{what} boards")
    for flags in (FeatureFlags(), FeatureFlags(True, False, True, False)):
        diff("grouped_flagship", kernels.grouped_flagship(s, cfg, P, "features", flags)[0],
             _grouped_features_of(want[0], cfg, flags), f"{what} features {tuple(flags)}")
    ts = turbo.from_flagship(s, cfg)
    lines = 0
    for max_clear in ((4, cfg.height) if stacks else (4,)):
        for mode, plain in (("features", tg.placements_plain), ("boards", tg.placement_boards_plain)):
            ref = plain(ts, cfg, P, max_clear)
            for k, (a, b) in enumerate(zip(kernels.grouped_placements(ts, cfg, P, max_clear, mode), ref)):
                diff("grouped_placements", a, b, f"{what} turbo {mode} max_clear={max_clear} output {k}")
            lines = max(lines, int(ref[3].max()))
    return {"illegal": int((want[1] == 0).sum()), "game_over": int(want[2].sum()),
            "max_lines": int(want[3].max()), "turbo_max_lines": lines}


def grouped_flagship_diff(s, cfg, P, what, n=None) -> dict:
    """``grouped_flagship`` in its three modes (features under all flags)
    against ``placements_plain`` on the first ``n`` envs of the flagship
    state ``s`` (all of them by default; the launch takes all), and the
    share of candidates that clear rows (the kernel folds those; it patches
    the env's features for the others)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import engine, grouped

    n = s.board.shape[0] if n is None else n
    head = engine.EngineState(**{k: (getattr(s, k)[:, :n] if k == "key" else getattr(s, k)[:n]).contiguous()
                                 for k in engine.FIELDS})
    want = grouped.placements_plain(head, cfg, P)
    for k, (a, b) in enumerate(zip(kernels.grouped_flagship(s, cfg, P, "ids"), want)):
        diff("grouped_flagship", a[:n], b, f"{what} ids output {k}")
    diff("grouped_flagship", kernels.grouped_flagship(s, cfg, P, "boards")[0][:n], want[0].float(),
         f"{what} boards")
    diff("grouped_flagship", kernels.grouped_flagship(s, cfg, P, "features")[0][:n],
         _grouped_features_of(want[0], cfg, None), f"{what} features")
    return {"envs_checked": n, "clearing_share": float((want[3] > 0).float().mean()),
            "illegal_share": float((want[1] == 0).float().mean())}


def check_surface_geometries(dev) -> dict:
    """Phase 35: the six surface kernels bit-equal to their plain versions
    at every geometry of :func:`surface_geometries`, each built for it in
    phase 2, and every build of ``flagship_step`` against the plain step
    at each step of the trajectories and on the stacks:
    ``observe_dict`` (and its strips), ``compose_rgb``,
    ``render_rgb84`` (wherever JAX's resize takes the composite) and
    ``feature_vector`` (all 16 flag sets on the first state) on 200-step
    flagship trajectories at B = 1001 and 1 (the plain versions on the two
    batches side by side); ``grouped_flagship``
    (ids, boards, features) and ``grouped_placements`` (features, boards)
    on every 25th state of both, and on hand-built stacks with up to six
    full rows (the turbo engine's envelope at ``max_clear`` 4 and at the
    board's height)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import RewardsMapping
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb_plain, feature_vector_plain
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(35)
    rw = RewardsMapping()
    t0 = time.perf_counter()
    runs = []
    for name, cfg, P in surface_geometries():
        pad = cfg.padding
        rgb84 = _rgb84_taken(cfg, P)
        fs = [kernels.flagship_init(batch_keys(prng_key(35 + B), B, device=dev), cfg, P) for B in SURF_GEO_B]

        def plain_all(f):
            d = engine.observe_dict_plain(f, cfg, P)
            out = {**d, "rgb": compose_rgb_plain(d["board"], d["queue"], d["holder"], P),
                   "features": feature_vector_plain(f.board[:, :-pad, pad:-pad], FeatureFlags())}
            if rgb84:
                out["rgb84"] = engine.render_rgb84_plain(f, cfg, P)
            return out

        grouped_stats = []
        # the plain step on both batches side by side, replayed from a CUDA graph
        plain_step = _graphed(lambda f, a: engine.step_plain(f, a, cfg, P, rw), _cat_flagship(fs),
                              torch.zeros((sum(SURF_GEO_B),), dtype=torch.int32, device=dev))
        for i in range(SURF_GEO_STEPS + 1):
            what = f"{name} @ {i}"
            f_all = _cat_flagship(fs)
            want = plain_all(f_all)
            ds = [kernels.observe_dict(s, cfg, P) for s in fs]
            for k in ("board", "active_tetromino_mask", "queue", "holder"):
                diff("observe_dict", torch.cat([d[k] for d in ds]), want[k], f"{what} {k}")
            strips = [kernels.observe_dict(s, cfg, P, strips_only=True) for s in fs]
            for k in ("queue", "holder"):
                diff("observe_dict", torch.cat([d[k] for d in strips]), want[k], f"{what} strips_only {k}")
            diff("compose_rgb", torch.cat([kernels.compose_rgb(d["board"], d["queue"], d["holder"], P)
                                           for d in ds]), want["rgb"], f"{what} rgb")
            if rgb84:
                diff("render_rgb84", torch.cat([kernels.render_rgb84(s, cfg, P) for s in fs]),
                     want["rgb84"], f"{what} rgb84")
            diff("feature_vector", torch.cat([kernels.feature_vector(s.board[:, :-pad, pad:-pad], FeatureFlags())
                                              for s in fs]), want["features"], f"{what} features")
            if i == 0:
                crop = f_all.board[:, :-pad, pad:-pad]
                for flags in FLAG_SETS:
                    flags = FeatureFlags(*flags)
                    feature_builds_diff(crop, flags, feature_vector_plain(crop, flags), f"{what} features {tuple(flags)}")
            if i % SURF_GEO_GROUPED_EVERY == 0:
                for s in fs:
                    grouped_stats.append(_check_grouped_surface(s, cfg, P, f"{what} B={s.board.shape[0]}"))
            if i == SURF_GEO_STEPS:
                break
            acts = [_flagship_actions(s.board.shape[0], g, dev) for s in fs]
            fs = [o[0] for o in flagship_builds_diff(list(zip(fs, acts)), cfg, P, rw,
                                                     plain_step(f_all, torch.cat(acts)), f"{what} step")]
        del plain_step
        # hand-built stacks: up to six full rows, pieces at random windows,
        # full holders, and a quarter of the envs stacked to the ceiling
        s, _ = _wide_stacks(cfg, P, SURF_GEO_B[0], g, dev, seed=350)
        board = s.board.clone()
        board[: SURF_GEO_B[0] // 4, : cfg.height // 3 + 1, pad : pad + cfg.width] = 3
        s = s.replace(board=board, holder_count=torch.full_like(s.holder_count, cfg.holder_size),
                      holder_piece=torch.randint(0, int(P.ids.shape[0]), s.holder_piece.shape, generator=g,
                                                 device=dev, dtype=torch.int32))
        d, dp = kernels.observe_dict(s, cfg, P), engine.observe_dict_plain(s, cfg, P)
        for k in dp:
            diff("observe_dict", d[k], dp[k], f"{name} stacks {k}")
        compose_builds_diff(d["board"], d["queue"], d["holder"], P, 1,
                            compose_rgb_plain(dp["board"], dp["queue"], dp["holder"], P), f"{name} stacks rgb")
        if rgb84:
            diff("render_rgb84", kernels.render_rgb84(s, cfg, P), engine.render_rgb84_plain(s, cfg, P),
                 f"{name} stacks rgb84")
        crop = s.board[:, :-pad, pad:-pad]
        diff("feature_vector", kernels.feature_vector(crop, FeatureFlags()), feature_vector_plain(crop),
             f"{name} stacks features")
        drops = torch.where(torch.rand((SURF_GEO_B[0],), generator=g, device=dev) < 0.5, 5,
                            torch.randint(0, 8, (SURF_GEO_B[0],), generator=g, device=dev)).to(torch.int32)
        stack_step = engine.step_plain(s, drops, cfg, P, rw)
        flagship_builds_diff([(s, drops)], cfg, P, rw, stack_step, f"{name} stacks step")
        stacks = _check_grouped_surface(s, cfg, P, f"{name} stacks", stacks=True)
        stacks["step_max_lines"] = int(stack_step[3].max())
        stacks["observe_dict_choices"] = observation_choices_diff(dev, cfg, P, f"phase 35 {name}",
                                                                  ("observe_dict",))["observe_dict"]
        if stacks["max_lines"] < 2 or stacks["illegal"] == 0 or stacks["game_over"] == 0:
            raise AssertionError(f"{name}: the hand-built stacks made no multi-line, illegal or "
                                 f"game-over candidate: {stacks}")
        runs.append({"geometry": name, "config": cfg._asdict(), "pieces": int(P.ids.shape[0]),
                     "piece_side": _side(P), "B": list(SURF_GEO_B), "steps": SURF_GEO_STEPS,
                     "render_rgb84": rgb84, "flagship_step_lanes": list(kernels.FLAGSHIP_LANES),
                     "grouped_states": len(grouped_stats),
                     "illegal_candidates": sum(x["illegal"] for x in grouped_stats),
                     "game_over_candidates": sum(x["game_over"] for x in grouped_stats),
                     "stacks": stacks})
        emit({"phase": "surface_geometries", **runs[-1], "seconds": time.perf_counter() - t0})
    torch.cuda.synchronize()
    out = {"bit_equal": True, "geometries": [r["geometry"] for r in runs],
           "seconds": time.perf_counter() - t0}
    emit({"phase": "surface_geometries_summary", **out,
          "max_abs_err": {k: MAX_ERR[k] for k in SURFACE_KERNELS}})
    return out


def check_grouped_engines_wide(dev) -> dict:
    """Phase 36: the turbo grouped engine equal to the flagship grouped
    engine on the card at 30x14 without gravity (tests/test_wide_boards.py:
    165-191): 4096 envs, 50 steps of random legal placements (one in ten
    uniform over all candidates, so some are illegal): features, masks,
    rewards, dones, lines and every env field through ``from_flagship``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import grouped, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(36)
    cfg = EngineConfig(**GROUPED_WIDE)
    keys = batch_keys(prng_key(36), GROUPED_WIDE_B, device=dev)
    t0 = time.perf_counter()
    kernels.reset_launches()
    fgs, fobs = grouped.reset(keys, cfg, mode="features", device=dev)
    tgs, tobs = tg.reset(keys, cfg, device=dev)
    lines = dones = illegal = 0
    for i in range(GROUPED_WIDE_STEPS + 1):
        if not (torch.equal(bits(fobs), bits(tobs)) and torch.equal(fgs.mask.T, tgs.mask)):
            raise AssertionError(f"30x14: flagship and turbo grouped observations differ @ {i}")
        ft = turbo.from_flagship(fgs.env, cfg)
        for k in turbo.FIELDS:
            if not torch.equal(bits(getattr(ft, k)), bits(getattr(tgs.env, k))):
                raise AssertionError(f"30x14: flagship and turbo grouped {k} differ @ {i}")
        if i == GROUPED_WIDE_STEPS:
            break
        a = _surface_actions(fgs.mask, g, dev, 0.1)
        illegal += int((fgs.mask.gather(1, a.long()[:, None])[:, 0] == 0).sum())
        fgs, fobs, fr, fd, fi = grouped.step(fgs, a, cfg, mode="features")
        tgs, tobs, tr, td, ti = tg.step(tgs, a, cfg)
        for got, ref, what in ((fr, tr, "reward"), (fd, td, "done"),
                               (fi["lines_cleared"], ti["lines_cleared"], "lines")):
            if not torch.equal(bits(got), bits(ref)):
                raise AssertionError(f"30x14: flagship and turbo grouped {what} differ @ {i}")
        lines += int(fi["lines_cleared"].sum())
        dones += int(fd.sum())
    torch.cuda.synchronize()
    T = GROUPED_WIDE_STEPS
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = {"flagship_init": T + 1, "flagship_step": T, "grouped_flagship": T + 1,
            "turbo_init": T + 1, "turbo_step": T, "grouped_placements": T + 1}
    if launches != want:
        raise AssertionError(f"phase 36 launches {launches}, want {want}")
    held = grouped_flagship_diff(fgs.env, cfg, turbo.PIECES, "phase 36 last state", n=1024)
    out = {"config": GROUPED_WIDE, "B": GROUPED_WIDE_B, "steps": T, "lines": lines, "done": dones,
           "illegal_actions": illegal, "launches": launches, "seconds": time.perf_counter() - t0,
           "bit_equal": held}
    if illegal == 0 or dones == 0:
        raise AssertionError(f"phase 36 took no illegal action or ended no episode: {out}")
    emit({"phase": "grouped_engines_wide", "equal": True, **out})
    return out


def run_grouped_engines_wide(dev, smi) -> dict:
    """Phase 38: the flagship and the turbo grouped engine at 30x20 without
    gravity, 4096 envs, features mode, 32 steps of random legal placements
    (phase 28's shape, ``bench.py:402-406``): step ms and placements/s on
    the host's clock, exact launch counts, the kernels' device ms."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, grouped, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(38)
    cfg = EngineConfig(**GROUPED_RATE_WIDE)
    B, T, A = GROUPED_ENGINE_B, GROUPED_ENGINE_STEPS, cfg.width * 4
    keys = batch_keys(prng_key(38), B, device=dev)
    out = {}
    total = {k: 0 for k in kernels.LAUNCHES}
    for impl in ("flagship", "turbo"):
        if impl == "flagship":
            gs, obs = grouped.reset(keys, cfg, mode="features", device=dev)
            step = functools.partial(grouped.step, config=cfg, mode="features")
            mask_of = lambda gs: gs.mask  # noqa: E731
        else:
            gs, obs = tg.reset(keys, cfg, device=dev)
            step = functools.partial(tg.step, config=cfg)
            mask_of = lambda gs: gs.mask.T  # noqa: E731
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(T):
            a = _surface_actions(mask_of(gs), g, dev, 0.0)
            gs, obs, r, d, info = step(gs, a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        names = {"flagship": ("flagship_step", "flagship_init", "grouped_flagship"),
                 "turbo": ("turbo_step", "turbo_init", "grouped_placements")}[impl]
        if got != {k: T for k in names}:
            raise AssertionError(f"grouped engine ({impl}, 30x20) launches {got}, want {T} of {names}")
        for k, v in got.items():
            total[k] += v
        if obs.shape != (B, A, cfg.width + 3) or not torch.isfinite(obs).all():
            raise AssertionError(f"grouped engine ({impl}, 30x20) observation {tuple(obs.shape)} not finite")
        drop = torch.full((B,), 5, dtype=torch.int32, device=dev)
        held = (grouped_flagship_diff(gs.env, cfg, engine.PIECES, "phase 38 final state", n=1024)
                if impl == "flagship" else None)
        if impl == "flagship":
            parts = {
                "grouped_flagship": device_ms(lambda: kernels.grouped_flagship(gs.env, cfg, engine.PIECES,
                                                                               "features"), 20),
                "hard_drop": device_ms(lambda: kernels.flagship_step(gs.env, drop, cfg, engine.PIECES,
                                                                     RewardsMapping()), 20),
                "auto_reset_init": device_ms(lambda: kernels.flagship_init(gs.env.key.T.contiguous(), cfg,
                                                                           engine.PIECES), 20)}
        else:
            parts = {
                "grouped_placements": device_ms(lambda: kernels.grouped_placements(gs.env, cfg, turbo.PIECES),
                                                20),
                "hard_drop": device_ms(lambda: kernels.turbo_step(gs.env, drop, cfg, turbo.PIECES,
                                                                  RewardsMapping()), 20),
                "auto_reset_init": device_ms(lambda: kernels.turbo_init(gs.env.key, cfg, turbo.PIECES,
                                                                        key_rows=True), 20)}
        a = _surface_actions(mask_of(gs), g, dev, 0.0)
        step_call = call_ms(lambda: step(gs, a), 20)
        parts["selects_and_rest_call"] = step_call - sum(parts.values())
        out[impl] = {"B": B, "steps": T, "wall_s": wall, "step_ms": 1e3 * wall / T,
                     "placements_per_s": B * T / wall, "candidates_per_s": A * B * T / wall,
                     "step_call_ms": step_call, "parts_device_ms": parts,
                     **({"bit_equal": held} if held else {})}
        emit({"phase": "grouped_engines_wide_rate", "impl": impl, "config": GROUPED_RATE_WIDE, **out[impl],
              "launches": got, "nvidia_smi": smi})
    return {"launches": total, "steps": 2 * T, "times": out}


def grouped_flagship_ops(cfg, P, mode, lines) -> int:
    """32-bit operations of one ``grouped_flagship`` launch at ``cfg`` in
    ``mode``, by the kernel's own count (csrc/grouped_flagship.cu), for the candidates
    whose ``lines`` (int32[B, A], the launch's own) it got: an env's shared
    work once over its A candidates (3 a padded cell for its words and
    column tops, 2 a playfield cell for its filled tops in features mode),
    then a candidate's drop from the column tops (4 a piece cell), its S
    window rows (two cropped words, 8 a piece cell, 2 a word for fullness)
    and 30 of setup and outputs; in features mode the S columns under the
    window patched (3 + 3 S each), S + 1 bumpiness pairs (8 each), the
    window rows' counts (2 + a word each) and the W heights copied (2 each),
    and for each candidate that clears rows (this launch's data) the fold of
    its rows (1 + 3 a plane and word, features.cuh) and its read-out (6 a
    column); in the board modes 3.5 an output cell (its byte built in shared
    memory, then 4 bytes converted and stored a word)."""
    H, PW, W, h, S = cfg.padded_height, cfg.padded_width, cfg.width, cfg.height, _side(P)
    nw, nwf = (PW + 31) // 32, (W + 31) // 32
    planes = max(1, int(h).bit_length())
    n_cand, n_fold = lines.numel(), int((lines > 0).sum())
    shared = (3 * H * PW + (2 * h * W if mode == "features" else 0)) // (4 * W)
    base = shared + 4 * S * S + S * (4 * nw + 8 * S + 2 * nwf) + 30
    if mode != "features":
        return n_cand * (base + 7 * H * PW // 2)
    patch = S * (3 + 3 * S) + 8 * (S + 1) + S * (2 + nwf) + 2 * W
    return n_cand * (base + patch) + n_fold * (h * (1 + 3 * planes * nwf) + 6 * W)


def _surface_ops(cfg, P) -> dict:
    """32-bit operations a unit of each surface function needs at ``cfg``,
    by the kernels' own count, generalised from phases 25 and 30 (for
    ``grouped_flagship`` and ``grouped_placements``: :func:`grouped_flagship_ops`
    and :func:`grouped_placements_ops`): an env of ``feature_vector`` (3 a cell, 15 a row, the
    read-out) and ``observe_dict`` (10 a board cell, 8 a mask cell, 10 a
    strip cell), a pixel of ``compose_rgb`` (12) and an env of
    ``render_rgb84`` (:func:`render_ops`)."""
    H, PW, W, h, S = cfg.padded_height, cfg.padded_width, cfg.width, cfg.height, _side(P)
    strips = S * S * (cfg.queue_size + cfg.holder_size)
    side = S * max(cfg.queue_size, cfg.holder_size)
    return {"feature_vector": h * (3 * W + 15) + 6 * W,
            "observe_dict": 18 * H * PW + 10 * strips, "compose_rgb": 12 * H * (PW + side),
            "render_rgb84": render_ops(H)}


def time_surface_wide(dev, smi) -> dict:
    """Phase 39: device ms of the six surface kernels at 30x20 and 61x12, B
    = 4096 and 65536 (the board modes at 4096), beside their bounds and
    their plain versions (at most at B = 1024 for the grouped ones and 4096
    for the others, scaled), on mid-game states (40 random steps in), and
    ``feature_vector`` and ``compose_rgb`` at 30x20's B = 1 and 120 (the
    observation wrappers' own batches)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, grouped, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb_plain, feature_vector_plain
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    g = torch.Generator(device=dev)
    g.manual_seed(39)
    rw = RewardsMapping()
    flags = FeatureFlags()
    out = {}
    for name, cfg, P in wide_geometries():
        if name not in WIDE_TIMED:
            continue
        ops = _surface_ops(cfg, P)
        H, PW, W, h, S = cfg.padded_height, cfg.padded_width, cfg.width, cfg.height, _side(P)
        A, pad = W * 4, cfg.padding
        strip_bytes = S * S * (cfg.queue_size + cfg.holder_size)
        img = H * (PW + S * max(cfg.queue_size, cfg.holder_size))
        for B in SURF_WIDE_TIME_B:
            big = B >= 65536
            s = kernels.flagship_init(batch_keys(prng_key(39 + B), B, device=dev), cfg, P)
            for _ in range(40):
                s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, rw)[0]
            t = turbo.from_flagship(s, cfg)
            d = kernels.observe_dict(s, cfg, P)
            crop = s.board[:, :-pad, pad:-pad]

            def head(x, n):
                return engine.EngineState(**{k: (getattr(x, k)[:, :n] if k == "key" else getattr(x, k)[:n])
                                             .contiguous() for k in engine.FIELDS})

            pg, po = min(B, SURF_WIDE_PLAIN_B["grouped"]), min(B, SURF_WIDE_PLAIN_B["other"])
            sg, so = head(s, pg), head(s, po)
            tgp = turbo.from_flagship(sg, cfg)
            dp = {k: v[:po].contiguous() for k, v in d.items()}
            cp = so.board[:, :-pad, pad:-pad]
            board_in = nbytes(s.board, s.piece, s.rotation)
            rows_in = nbytes(t.rows, t.piece, t.rotation)
            dict_in = nbytes(s.board, s.piece, s.rotation, s.x, s.y, s.queue, s.holder_piece,
                             s.holder_rotation, s.holder_count)
            flag = 4 + 1 + 4  # mask, game over, lines
            held = grouped_flagship_diff(s, cfg, P, f"phase 39 {name} B={B}", n=pg)
            lines = kernels.grouped_flagship(s, cfg, P, "ids")[3]
            tlines = kernels.grouped_placements(t, cfg, P)[3]
            entries = {
                ("grouped_flagship", "features"): (
                    lambda: kernels.grouped_flagship(s, cfg, P, "features"),
                    lambda: _grouped_features_of(grouped.placements_plain(sg, cfg, P)[0], cfg, flags),
                    pg, board_in + B * A * (4 * (W + 3) + flag), grouped_flagship_ops(cfg, P, "features", lines)),
                ("grouped_flagship", "ids"): (
                    lambda: kernels.grouped_flagship(s, cfg, P, "ids"),
                    lambda: grouped.placements_plain(sg, cfg, P)[0], pg,
                    board_in + B * A * (H * PW + flag), grouped_flagship_ops(cfg, P, "ids", lines)),
                ("grouped_placements", "features"): (
                    lambda: kernels.grouped_placements(t, cfg, P),
                    lambda: tg.placements_plain(tgp, cfg, P), pg,
                    rows_in + B * A * (4 * (W + 3) + flag), grouped_placements_ops(cfg, P, "features", tlines)),
                ("feature_vector", None): (
                    lambda: kernels.feature_vector(crop, flags), lambda: feature_vector_plain(cp, flags), po,
                    B * (h * W + 4 * (W + 3)), B * ops["feature_vector"]),
                ("observe_dict", None): (
                    lambda: kernels.observe_dict(s, cfg, P), lambda: engine.observe_dict_plain(so, cfg, P), po,
                    dict_in + B * (2 * H * PW + strip_bytes), B * ops["observe_dict"]),
                ("compose_rgb", None): (
                    lambda: kernels.compose_rgb(d["board"], d["queue"], d["holder"], P),
                    lambda: compose_rgb_plain(dp["board"], dp["queue"], dp["holder"], P), po,
                    B * (H * PW + strip_bytes + 3 * img), B * img * COMPOSE_OPS_PER_PIXEL),
                ("render_rgb84", None): (
                    lambda: kernels.render_rgb84(s, cfg, P), lambda: engine.render_rgb84_plain(so, cfg, P), po,
                    dict_in + B * 84 * 84, B * ops["render_rgb84"]),
            }
            if not big:
                entries[("grouped_flagship", "boards")] = (
                    lambda: kernels.grouped_flagship(s, cfg, P, "boards"),
                    lambda: grouped.placements_plain(sg, cfg, P)[0].float(), pg,
                    board_in + B * A * (4 * H * PW + flag), grouped_flagship_ops(cfg, P, "boards", lines))
                entries[("grouped_placements", "boards")] = (
                    lambda: kernels.grouped_placements(t, cfg, P, 4, "boards"),
                    lambda: tg.placement_boards_plain(tgp, cfg, P), pg,
                    rows_in + B * A * (4 * h * W + flag), grouped_placements_ops(cfg, P, "boards", tlines))
            for (kname, mode), (kernel_fn, plain_fn, pb, io, n_ops) in entries.items():
                entry = timed_pair(kernel_fn, plain_fn, 10 if big else 50, 1 if pb >= 1024 else 5, io, n_ops)
                entry.update(plain_ms=entry["plain_ms"] * B / pb, plain_B=pb, library_ms=None,
                             envs_per_s=B / (entry["ms"] * 1e-3), **(held if kname == "grouped_flagship" else {}))
                out.setdefault(name, {}).setdefault(kname, {})[f"{mode}@{B}" if mode else B] = entry
            emit({"phase": "surface_wide_times", "geometry": name, "B": B,
                  "kernels": {k: {m: e for m, e in v.items() if str(m).endswith(str(B))}
                              for k, v in out[name].items()}, "nvidia_smi": smi})
            del s, t, d, crop, sg, so, tgp, dp, cp, lines, tlines
            torch.cuda.empty_cache()
        if name == "30x20":  # the observation wrappers' own batches there: 1 and the 120 candidates
            for k, by_b in wrapper_kernel_times(dev, cfg, P, (1, A), 39).items():
                out[name][k].update(by_b)
            emit({"phase": "surface_wide_times", "geometry": name, "B": [1, A],
                  "kernels": {k: {b: out[name][k][b] for b in (1, A)} for k in ("feature_vector", "compose_rgb")},
                  "nvidia_smi": smi})
    return out


# ---------------------------------------------------------------------------
# 40.-43. the compat functional engine and the exact grayscale
# ---------------------------------------------------------------------------

GRAY_BATCH = (512, 84, 84, 3)
GRAY_ALL = 1 << 24  # every RGB triple
GRAY_JAX_OFF = 164  # triples where the exact grayscale differs from numpy's float64 (ops/image.py:25-28)
GRAY_OPS_PER_PIXEL = 14  # 6 table lookups, 4 adds, 2 shifts, the byte extract and the pack
FN_B = (4096, 1001, 1)
FN_STEPS = 300
FN_RESTART_EVERY = 25  # random play ends a game within 8-27 steps: ended games start afresh
FN_STACKS = 512  # hand-built states a geometry, each taking every action 0-7
FN_PATH_B, FN_PATH_T, FN_CPU_B = 65536, 64, 1024
FN_TIME_B = (1, 8192, 65536)
FN_LIVE_STEPS = 8  # phase 43 times the state 8 steps into a fresh rollout, most games live


def fn_geometries():
    """``(name, config, queue kind)`` of phase 41: the default board, no
    gravity, a uniform queue of 5 (its off-by-one draws pieces 0-3), width
    30, and 8x12 with padding 2, where a piece stands low enough (``y + 1 >
    H + pad - 4``) for the window clamps to bind."""
    from tetris_gymnasium_torch.config import EnvConfig

    return [("10x20", EnvConfig(), "bag"), ("10x20-nograv", EnvConfig(gravity_enabled=False), "bag"),
            ("uniform5", EnvConfig(queue_size=5), "uniform"), ("30x20", EnvConfig(width=30), "bag"),
            ("8x12-pad2", EnvConfig(width=8, height=12, padding=2), "bag")]


def _fn_queue(kind):
    from tetris_gymnasium_torch.ops.queue import BAG_QUEUE, UNIFORM_QUEUE

    return BAG_QUEUE if kind == "bag" else UNIFORM_QUEUE


def _fn_rows(s, o, n):
    """Envs ``o .. o + n`` of a compat state (contiguous views)."""
    from tetris_gymnasium_torch.core import fn_env

    return fn_env.FnState(**{k: getattr(s, k)[o : o + n] for k in fn_env.FIELDS})


def _fn_cat(parts):
    """Kernel outputs of several batches, concatenated field by field."""
    import dataclasses

    if dataclasses.is_dataclass(parts[0]):
        return type(parts[0])(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                                 for f in dataclasses.fields(parts[0])})
    return torch.cat(parts)


def _fn_diff(kernel, got, want, what):
    """Compat states (field by field) or tensors, bit for bit."""
    from tetris_gymnasium_torch.core import fn_env

    if isinstance(want, fn_env.FnState):
        _fields_diff(kernel, got, want, fn_env.FIELDS, what)
    else:
        diff(kernel, got, want, what)


def fn_step_builds(cfg, board) -> list:
    """The builds of ``fn_step`` that a board of ``cfg`` at ``board``'s address takes: both where the
    bulk copies fit (``kernels.fn_step_build``), else the words build."""
    from tetris_gymnasium_torch import kernels

    return [b for b in kernels.FN_STEP_BUILDS if b == "words" or kernels.fn_step_build(cfg, board) == "bulk"]


def check_gray_exact(dev) -> dict:
    """Phase 40: ``grayscale_u8_exact`` bit-equal to its plain version over
    all 2**24 RGB triples and on a random ``[512, 84, 84, 3]`` batch; the
    triples where it differs from numpy's float64 formula, counted for the
    kernel and the plain version."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import image

    t0 = time.perf_counter()
    i = torch.arange(GRAY_ALL, device=dev, dtype=torch.int32)
    rgb = torch.stack([i >> 16, (i >> 8) & 255, i & 255], dim=-1).to(torch.uint8)
    got, plain = kernels.grayscale_u8_exact(rgb), image.grayscale_u8_exact_plain(rgb)
    diff("grayscale_u8_exact", got, plain, "all 2**24 RGB triples")
    want = np.sum(np.multiply(rgb.cpu().numpy(), np.array([0.2125, 0.7154, 0.0721])), axis=-1).astype(np.uint8)
    off = {"kernel": int((got.cpu().numpy() != want).sum()), "plain": int((plain.cpu().numpy() != want).sum())}
    if off["kernel"] != off["plain"]:
        raise AssertionError(f"grayscale_u8_exact: {off} triples differ from numpy's float64")
    g = torch.Generator(device=dev)
    g.manual_seed(40)
    batch = torch.randint(0, 256, GRAY_BATCH, generator=g, device=dev, dtype=torch.uint8)
    diff("grayscale_u8_exact", kernels.grayscale_u8_exact(batch), image.grayscale_u8_exact_plain(batch),
         f"random {list(GRAY_BATCH)}")
    torch.cuda.synchronize()
    out = {"phase": "grayscale_u8_exact", "bit_equal": True, "triples": GRAY_ALL,
           "differ_from_numpy_float64": off, "jax_documented": GRAY_JAX_OFF,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def _fn_stacks(cfg, kind, n, dev, seed):
    """Compat states on hand-built stacks, made in numpy and carried to the
    card by ``state_from_numpy``, each repeated for the 8 actions 0-7: 1-4
    full rows at the bottom, random cells below the top half and a
    non-empty row 0 that is not full (so that a clear copies it), a random
    piece at a random position (the clamps included), half the queues at
    their refill boundary, a fifth of the games over."""
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    rng = np.random.default_rng(seed)
    _, s, _ = fn_env.reset_plain(batch_keys(prng_key(seed), n, device="cpu"), cfg, queue_fns=_fn_queue(kind))
    st = fn_env.state_to_numpy(s)
    H, W, pad, qs = cfg.height, cfg.width, cfg.padding, cfg.queue_size
    inner = np.where(rng.random((n, H, W)) < 0.5, 5, 0).astype(np.int8)
    inner[:, 1 : H // 2] = 0
    inner[:, 0, 0], inner[:, 0, 1] = 6, 0
    n_full = rng.integers(1, 5, n)
    inner[np.arange(H)[None, :] >= H - n_full[:, None]] = 3
    st["board"][:, :H, pad : pad + W] = inner
    st.update(piece=rng.integers(0, qs, n), rotation=rng.integers(0, 4, n),
              x=rng.integers(-3, cfg.padded_width, n), y=rng.integers(0, cfg.padded_height, n),
              queue_index=np.where(rng.random(n) < 0.5, qs, rng.integers(0, qs, n)),
              game_over=rng.random(n) < 0.2)
    st = fn_env.state_from_numpy({k: np.repeat(v, 8, axis=0) for k, v in st.items()}, device=dev)
    return st, (torch.arange(8 * n, device=dev) % 8).to(torch.int32)


FN_RESET_B = (1, 2, 3, 17, 4096, 65536)


def fn_reset_diff(dev, cfg, kind, seed, what) -> None:
    """``fn_reset`` bit-equal to ``reset_plain`` in every field and the
    observation at ``FN_RESET_B``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.pieces import PIECES

    for i, B in enumerate(FN_RESET_B):
        keys = batch_keys(prng_key(seed + i), B, device=dev)
        want = fn_env.reset_plain(keys, cfg, PIECES, _fn_queue(kind))
        got = kernels.fn_reset(keys, cfg, PIECES, kind)
        for part, w, field in zip(got, want, ("keys", "state", "obs")):
            _fn_diff("fn_reset", part, w, f"{what} B={B} {field}")


def check_fn_kernels(dev) -> dict:
    """Phase 41: ``fn_reset``, ``fn_step`` and ``fn_observe`` bit-equal to
    their plain versions at every geometry of :func:`fn_geometries`, in every
    field, the observation, reward, terminated and lines: 300-step
    random-action trajectories (actions 0-7, 7 a no-op) at B = 4096, 1001 and
    1 (the plain versions once on the three batches side by side, replayed
    from a CUDA graph; ended games start afresh every 25 steps), the
    observation of every state, then the hand-built states of
    :func:`_fn_stacks`: the row-0 copy of a line clear, a refill and frozen
    games must each show."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.pieces import PIECES
    from tetris_gymnasium_torch.utils.tree import select_tree

    g = torch.Generator(device=dev)
    g.manual_seed(41)
    t0 = time.perf_counter()
    spans = [(sum(FN_B[:i]), B) for i, B in enumerate(FN_B)]
    total = sum(FN_B)
    summary = {}
    for gi, (name, cfg, kind) in enumerate(fn_geometries()):
        qf = _fn_queue(kind)
        fn_reset_diff(dev, cfg, kind, 1000 + 100 * gi, name)

        def keys_at(seed):
            return torch.cat([batch_keys(prng_key(seed + j), B, device=dev) for j, B in enumerate(FN_B)])

        def reset_both(keys, what):
            k = [kernels.fn_reset(keys[o : o + B], cfg, PIECES, kind) for o, B in spans]
            p = fn_env.reset_plain(keys, cfg, PIECES, qf)
            for part, want, field in zip(zip(*k), p, ("keys", "state", "obs")):
                _fn_diff("fn_reset", _fn_cat(part), want, f"{name} {what} {field}")
            return p[1]

        s = reset_both(keys_at(100 * gi), "reset")
        builds = fn_step_builds(cfg, s.board)
        if builds[0] != kernels.fn_step_build(cfg, s.board):
            raise AssertionError(f"{name}: the wrapper takes {kernels.fn_step_build(cfg, s.board)}")
        plain_step = _graphed(lambda st, a: fn_env.step_plain(st, a, cfg, PIECES, qf), s,
                              torch.zeros((total,), dtype=torch.int32, device=dev))
        ended = lines = live = 0
        for i in range(FN_STEPS):
            a = torch.randint(0, 8, (total,), generator=g, device=dev, dtype=torch.int32)
            # the wrapper's build first, then the others; all before the plain
            # step's replay, which overwrites s (the graph's own outputs)
            ks = {b: [kernels.fn_step(_fn_rows(s, o, B), a[o : o + B], cfg, PIECES, kind,
                                      build=None if b == builds[0] else b) for o, B in spans]
                  for b in builds}
            p = plain_step(s, a)
            for b, k in ks.items():
                for part, want, field in zip(zip(*k), p, ("state", "obs", "reward", "terminated", "lines")):
                    _fn_diff("fn_step", _fn_cat(part), want, f"{name} step {i} {field} ({b})")
            k = ks[builds[0]]
            obs = [kernels.fn_observe(part[0], cfg, PIECES) for part in k]
            _fn_diff("fn_observe", _fn_cat(obs), p[1], f"{name} observe {i}")
            live += int((~s.game_over).sum())
            ended += int((p[3] & ~s.game_over).sum())
            lines += int(p[4].sum())
            s = p[0]
            if i % FN_RESTART_EVERY == FN_RESTART_EVERY - 1:
                fresh = reset_both(keys_at(100 * gi + i + 1), f"restart {i}")
                s = select_tree(s.game_over, fresh, s, minor=())
        del plain_step

        st, a = _fn_stacks(cfg, kind, FN_STACKS, dev, 41 + gi)
        diff("fn_observe", kernels.fn_observe(st, cfg, PIECES), fn_env.observe_plain(st, cfg), f"{name} stacks obs")
        p = fn_env.step_plain(st, a, cfg, PIECES, qf)
        for b in builds:
            k = kernels.fn_step(st, a, cfg, PIECES, kind, build=b)
            for got, want, field in zip(k, p, ("state", "obs", "reward", "terminated", "lines")):
                _fn_diff("fn_step", got, want, f"{name} stacks {field} ({b})")
        new, pad, W = p[0], cfg.padding, cfg.width
        row0 = (new.board[:, 0, pad : pad + W] > 0).any(dim=1)
        shown = {"row0_copies": int(((p[4] > 0) & row0 & ~st.game_over).sum()),
                 "refills": int(((st.queue_index == cfg.queue_size) & (new.queue_index == 1)
                                 & ~st.game_over).sum()),
                 "frozen": int(st.game_over.sum()), "lines": p[4].bincount(minlength=5).tolist()}
        frozen = st.game_over
        if not (torch.equal(new.board[frozen], st.board[frozen]) and bool((p[2][frozen] == 0).all())
                and bool((p[4][frozen] == 0).all())):
            raise AssertionError(f"{name}: a game that was over changed")
        if min(shown["row0_copies"], shown["refills"], shown["frozen"]) == 0:
            raise AssertionError(f"{name}: the hand-built states did not show every case: {shown}")
        summary[name] = {"steps": FN_STEPS, "B": list(FN_B), "live_env_steps": live, "games_ended": ended,
                         "lines": lines, "stacks": shown, "fn_step_builds": builds,
                         "fn_reset_B": list(FN_RESET_B)}
    torch.cuda.synchronize()
    out = {"phase": "fn_kernels", "bit_equal": True, "geometries": summary,
           "max_abs_err": {k: MAX_ERR[k] for k in ("fn_reset", "fn_step", "fn_observe")},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_fn_path(dev, smi) -> dict:
    """Phase 42: the slice's path.  ``examples/play_random_functional.py``'s
    game from ``prng_key(42)`` on the card and in the plain versions on the
    CPU (steps, score and the last observation equal; steps/s, host-bound
    at B = 1; exact launch counts), then ``batched_reset`` and ``rollout``
    at B = 65536, T = 64 with random actions 0-6: env-steps/s, exact launch
    counts (one ``fn_reset``, one ``fn_step`` a step, no ``fn_observe``),
    and the first 1024 envs' trajectories equal to a CPU run of the same
    keys and actions."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EnvConfig
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.examples import play_random_functional as prf
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    no_launches = {k: 0 for k in kernels.LAUNCHES}
    kernels.reset_launches()
    card = prf.play("cuda")
    game_launches = dict(kernels.LAUNCHES)
    cpu = prf.play("cpu")
    if (card["steps"], card["score"]) != (cpu["steps"], cpu["score"]) or not np.array_equal(card["obs"], cpu["obs"]):
        raise AssertionError(f"the example's game: {card['steps']} steps, score {card['score']} on the card, "
                             f"{cpu['steps']}, {cpu['score']} on the CPU")
    if game_launches != {**no_launches, "fn_reset": 1, "fn_step": card["steps"]}:
        raise AssertionError(f"the example's launch counts {game_launches}")

    cfg = EnvConfig()
    g = torch.Generator(device=dev)
    g.manual_seed(42)
    keys = batch_keys(prng_key(42), FN_PATH_B, device=dev)
    actions = torch.randint(0, 7, (FN_PATH_T, FN_PATH_B), generator=g, device=dev, dtype=torch.int32)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, s0, obs0 = fn_env.batched_reset(keys, config=cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    final, (obs, reward, term, lines) = fn_env.rollout(s0, actions, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    if launches != {**no_launches, "fn_reset": 1, "fn_step": FN_PATH_T}:
        raise AssertionError(f"the rollout's launch counts {launches}")
    for t in (obs, reward):
        if not torch.isfinite(t.float()).all():
            raise AssertionError("the rollout gave a value that is not finite")

    n = FN_CPU_B
    _, c0, cobs0 = fn_env.batched_reset(keys[:n].cpu(), config=cfg, device="cpu")
    cfinal, cout = fn_env.rollout(c0, actions[:, :n].cpu(), cfg)
    diff("fn_reset", obs0[:n].cpu(), cobs0, "rollout reset obs (CPU)")
    for got, want, field in zip((obs, reward, term, lines), cout, ("obs", "reward", "terminated", "lines")):
        diff("fn_step", got[:, :n].cpu(), want, f"rollout {field} (CPU)")
    _fields_diff("fn_step", fn_env.FnState(**{k: getattr(final, k)[:n].cpu() for k in fn_env.FIELDS}),
                 cfinal, fn_env.FIELDS, "rollout final (CPU)")
    out = {"phase": "fn_path", "game": {"steps": card["steps"], "score": card["score"],
                                         "steps_per_s": card["steps"] / card["seconds"],
                                         "launches": {k: v for k, v in game_launches.items() if v}},
           "B": FN_PATH_B, "T": FN_PATH_T, "reset_s": t1 - t0, "rollout_s": t2 - t1,
           "env_steps_per_s": FN_PATH_B * FN_PATH_T / (t2 - t1),
           "games_ended": int((term[-1] & ~s0.game_over).sum()), "lines": int(lines.sum()),
           "launches": {k: v for k, v in launches.items() if v}, "cpu_equal_envs": n, "nvidia_smi": smi}
    emit(out)
    return {"launches": launches, "steps": FN_PATH_T, "game_launches": game_launches}


def _fn_step_ops(cfg) -> int:
    """32-bit operations of ``fn_step`` on one env, the kernel's own count on
    a locking hard drop: four 16-cell window tests and a drop of up to H
    tests (6 each a cell), the stamp, the compaction and the frame (4 a
    cell), two threefry blocks, a refill's QS more and its sort (80 a
    block, 4 a comparison), and the observation (8 a cell)."""
    H, cells, qs = cfg.padded_height, cfg.padded_height * cfg.padded_width, cfg.queue_size
    return (4 + H) * 16 * 6 + 4 * cells + 80 * (2 + qs) + 4 * qs * qs + 8 * cfg.height * cfg.width


def time_fn_kernels(dev, smi) -> dict:
    """Phase 43: device ms (a CUDA graph, the median of 7 replays) of
    ``fn_step`` and ``fn_observe`` at B = 1, 8192 and 65536 on live states
    (8 steps into a fresh rollout), ``fn_step`` also on frozen ones,
    ``fn_reset`` at the same B, and ``grayscale_u8_exact`` at 2**24 pixels
    and ``[512, 84, 84, 3]``, beside their bounds and plain versions."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EnvConfig
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.ops import image
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.pieces import PIECES

    cfg = EnvConfig()
    g = torch.Generator(device=dev)
    g.manual_seed(43)
    pad, h, w = cfg.padding, cfg.height, cfg.width
    out = {}
    for B in FN_TIME_B:
        big = B >= 65536
        keys = batch_keys(prng_key(43), B, device=dev)
        s = kernels.fn_reset(keys, cfg, PIECES)[1]
        for _ in range(FN_LIVE_STEPS):
            s = kernels.fn_step(s, torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32),
                                cfg, PIECES)[0]
        a = torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32)
        frozen = s.replace(game_over=torch.ones_like(s.game_over))
        state_bytes = nbytes(*(getattr(s, k) for k in fn_env.FIELDS))
        step_io = 2 * state_bytes + nbytes(a) + B * (h * w + 4 + 1 + 4)
        step_ops = B * _fn_step_ops(cfg)
        entries = {
            "fn_step": (lambda: kernels.fn_step(s, a, cfg, PIECES), lambda: fn_env.step_plain(s, a, cfg),
                        step_io, step_ops),
            "fn_step_frozen": (lambda: kernels.fn_step(frozen, a, cfg, PIECES),
                               lambda: fn_env.step_plain(frozen, a, cfg), step_io, step_ops),
            "fn_observe": (lambda: kernels.fn_observe(s, cfg, PIECES), lambda: fn_env.observe_plain(s, cfg),
                           nbytes(s.board[:, :h, pad : pad + w], s.piece, s.rotation, s.x, s.y, s.game_over)
                           + B * h * w, B * 8 * h * w),
            "fn_reset": (lambda: kernels.fn_reset(keys, cfg, PIECES), lambda: fn_env.reset_plain(keys, cfg),
                         2 * nbytes(keys) + state_bytes + B * h * w,
                         B * (80 * (2 + cfg.queue_size) + 4 * cfg.padded_height * cfg.padded_width)),
        }
        live = float((~s.game_over).float().mean())
        for name, (kernel_fn, plain_fn, io, ops) in entries.items():
            entry = timed_pair(kernel_fn, plain_fn, 20 if big else 100, 2 if big else 10, io, ops)
            entry.update(library_ms=None, envs_per_s=B / (entry["ms"] * 1e-3), live_share=live)
            if name.startswith("fn_step"):  # each build (bulk copies or words) on the same states
                st = frozen if name == "fn_step_frozen" else s
                entry["builds_ms"] = {b: device_ms(lambda: kernels.fn_step(st, a, cfg, PIECES, build=b),
                                                   20 if big else 100)
                                      for b in fn_step_builds(cfg, st.board)}
            out.setdefault(name, {})[B] = entry
        emit({"phase": "fn_times", "B": B, "live_share": live,
              "kernels": {k: v[B] for k, v in out.items()}, "nvidia_smi": smi})
        del s, frozen
        torch.cuda.empty_cache()
    emit({"phase": "fn_step_occupancy", "nvidia_smi": smi,  # cudaOccupancyMaxActiveBlocksPerMultiprocessor
          "builds": [kernels.fn_step_occupancy(cfg, PIECES, b) for b in kernels.FN_STEP_BUILDS]})
    for shape in ((GRAY_ALL, 3), GRAY_BATCH):
        rgb = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
        n = rgb.numel() // 3
        entry = timed_pair(lambda: kernels.grayscale_u8_exact(rgb), lambda: image.grayscale_u8_exact_plain(rgb),
                           20, 2, 4 * n, n * GRAY_OPS_PER_PIXEL)
        entry.update(library_ms=None, pixels_per_s=n / (entry["ms"] * 1e-3))
        out.setdefault("grayscale_u8_exact", {})[n] = entry
        emit({"phase": "gray_times", "shape": list(shape), "kernels": {"grayscale_u8_exact": entry},
              "nvidia_smi": smi})
    return out


# ---------------------------------------------------------------------------
# 44.-47. PPO on the pixel chain, and the from-scratch PPO curve
# ---------------------------------------------------------------------------

# Phase 44: a small fp32 pixel PPO on the card and on the CPU from the JAX
# run's initial weights, held as phase 23 holds the pixel DQN (each leaf's
# change within SMALL_PIX_PARAM_TOL of its norm).
SMALL_PIX_PPO_ENVS = 32
SMALL_PIX_PPO_CFG = dict(rollout_len=8, update_epochs=2, n_minibatches=2, frame_stack=4)
# its values and log-probs, card against CPU: float32 sums of up to 3136
# terms in another order, the bound the CPU tests hold the port to against JAX
SMALL_PIX_PPO_OUT_TOL = 1e-5
# Phase 45: examples/train_ppo.py --obs rgb84 --frame-stack 4 at the JAX
# example's defaults (2048 envs x 128 steps, 6 epochs of 8 minibatches,
# AtariActorCritic with a bf16 trunk, ent-coef 0.01), 3 train steps in one
# chunk, from the JAX run's initial weights (tools/export_grouped_init_params.py
# --net atari_actor_critic --frame-stack 4 --seed 1).
PIX_PPO_INIT = os.path.join(REPO, "results", "atari_actor_critic_k4_init_seed1.npz")
PIX_PPO_ENVS, PIX_PPO_T, PIX_PPO_STEPS, PIX_PPO_K = 2048, 128, 3, 4
PIX_PPO_ARGV = [
    "--obs", "rgb84", "--frame-stack", str(PIX_PPO_K), "--n-envs", str(PIX_PPO_ENVS),
    "--rollout-len", str(PIX_PPO_T), "--update-epochs", "6", "--n-minibatches", "8",
    "--iterations", str(PIX_PPO_STEPS), "--chunk", str(PIX_PPO_STEPS), "--seed", "1",
    "--init-params", PIX_PPO_INIT,
]
# Phase 47: examples/train_ppo.py at its defaults (board observations, the
# turbo engine, 2048 envs x 128 steps, 6 epochs of 8 minibatches, ent-coef
# 0.01, lr 2.5e-4, seed 1), the settings of the repo's from-scratch PPO
# record results/ppo.jsonl, from that JAX run's initial weights
# (tools/export_grouped_init_params.py --net actor_critic --seed 1).
# Iteration 1's reward per step is the rollout of the initial weights with
# the record's keys: within CURVE_START_TOL of the record's 0.1586.
# Iteration 10's must be at least CURVE_GATE times iteration 1's (the
# record: 0.5002 / 0.1586 = 3.15x).
PPO_INIT = os.path.join(REPO, "results", "ppo_init_seed1.npz")
PPO_CURVE = os.path.join(REPO, "results", "ppo.jsonl")
CURVE_ITERATIONS, CURVE_START_TOL, CURVE_GATE = 10, 0.005, 2.5
CURVE_ARGV = ["--n-envs", "2048", "--rollout-len", "128", "--iterations", str(CURVE_ITERATIONS),
              "--seed", "1", "--init-params", PPO_INIT]


def _rel_to_scale(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max()) / max(float(b.double().abs().max()), 1e-30)


def check_small_pixel_ppo() -> dict:
    """Phase 44: a small fp32 pixel PPO train step on the card (cuDNN's
    deterministic algorithms, no TF32) against the same step on the CPU."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.models.networks import AtariActorCritic
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    cfg = ppo.PPOConfig(**SMALL_PIX_PPO_CFG)
    env_config = EngineConfig(auto_reset=True)
    sample_step = ppo.sample_step_fn(env_config, "flagship", obs="rgb84")
    start = load_flat(PIX_PPO_INIT)
    out = {}
    with deterministic_cudnn(), fp32_math():
        for where in ("cuda", "cpu"):
            kernels.reset_launches()
            ts = ppo.init_train_state(threefry.prng_key(4), SMALL_PIX_PPO_ENVS, env_config, cfg,
                                      net=AtariActorCritic(in_channels=cfg.frame_stack,
                                                           dtype=torch.float32),
                                      impl="flagship", obs="rgb84", device=where, params=start)
            key0 = ts.key
            traj = ppo.rollout(ts, cfg, sample_step)[0]
            if where == "cuda":
                # the sampling build against its plain version on the card's own logits
                key, worst_ulps, lp_bit_equal = key0, 0, True
                with torch.no_grad():
                    for t in range(cfg.rollout_len):
                        key, act_key = threefry.split(key)
                        pa, plp = ppo.sample_actions_plain(ts.net(traj.obs[t])[0], act_key)
                        diff("flagship_step", traj.action[t], pa, f"small pixel PPO step {t} actions")
                        err = (traj.log_prob[t].double() - plp.double()).abs()
                        ulp = torch.from_numpy(np.spacing(plp.abs().cpu().numpy())).to(err.device)
                        if bool((err > 2.0**-22 + LOG_PROB_ULPS * ulp.double()).any()):
                            raise AssertionError(f"small pixel PPO step {t}: log_prob off the "
                                                 f"plain one by {float(err.max())}")
                        worst_ulps = max(worst_ulps, float((err / ulp.double()).max()))
                        lp_bit_equal &= torch.equal(bits(traj.log_prob[t]), bits(plp))
            ts, metrics = ppo.make_train_step(env_config, cfg, impl="flagship", obs="rgb84")(ts)
            out[where] = (traj, ts, to_flax_params(ts.net.state_dict(), "atari_actor_critic"),
                          {k: float(v) for k, v in metrics.items()}, dict(kernels.LAUNCHES))
    (tc, sc, pc, mc, lc), (tp, sp, pp, mp, _) = out["cuda"], out["cpu"]
    n = 2 * cfg.rollout_len  # the rollout above and the train step's own
    want = {**{k: 0 for k in lc}, "flagship_init": 1, "flagship_step": n, "flagship_step_sample": n,
            "render_rgb84": n + 1, "framestack_push": n, "gae": 1}
    if lc != want:
        raise AssertionError(f"small pixel PPO launch counts {lc}, want {want}")
    for k in ("obs", "action", "reward", "done"):
        if not torch.equal(bits(getattr(tc, k).cpu()), bits(getattr(tp, k))):
            raise AssertionError(f"small pixel PPO: rollout {k} differs between card and CPU")
    for k in engine.FIELDS:
        if not torch.equal(bits(getattr(sc.env_states, k).cpu()), bits(getattr(sp.env_states, k))):
            raise AssertionError(f"small pixel PPO: env {k} differs between card and CPU")
    if not torch.equal(sc.last_obs.cpu(), sp.last_obs):
        raise AssertionError("small pixel PPO: the window differs between card and CPU")
    out_rel = {k: _rel_to_scale(getattr(tc, k).cpu(), getattr(tp, k)) for k in ("value", "log_prob")}
    if max(out_rel.values()) > SMALL_PIX_PPO_OUT_TOL:
        raise AssertionError(f"small pixel PPO: values or log-probs differ by {out_rel} of "
                             "their scale between card and CPU")
    norm_worst, elem_worst = param_change_diff("small pixel PPO", start, pc, pp, SMALL_PIX_PARAM_TOL)
    result = {"phase": "small_pixel_ppo", "rollout_bit_equal": True, "env_bit_equal": True,
              "window_bit_equal": True, "envs": SMALL_PIX_PPO_ENVS, **SMALL_PIX_PPO_CFG,
              "launches_cuda": lc, "log_prob_max_ulps_vs_plain": worst_ulps,
              "log_prob_bit_equal_plain": lp_bit_equal, "card_vs_cpu_rel_to_scale": out_rel,
              "episodes_done": int(tc.done.sum()), "param_change_max_norm_rel_diff": norm_worst,
              "param_change_max_elem_rel_diff": elem_worst, "metrics_cuda": mc, "metrics_cpu": mp,
              "seconds": time.perf_counter() - t0}
    emit(result)
    return result


def train_pixel_ppo_full_width(dev, smi) -> dict:
    """Phase 45: ``examples/train_ppo.py --obs rgb84 --frame-stack 4`` at the
    JAX example's defaults, 3 train steps, then the trained weights' greedy
    evaluation."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.examples import train_ppo
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl.evaluate import evaluate_policy, greedy_logits
    from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic, load_flat

    args = train_ppo.parse_args(PIX_PPO_ARGV)
    events = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, []).append(ev)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, records = train_ppo.train(args, marks=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    n = PIX_PPO_STEPS * PIX_PPO_T  # a train step: T of each rollout kernel, one gae
    want = {**{k: 0 for k in launches}, "flagship_init": 1, "flagship_step": n,
            "flagship_step_sample": n, "render_rgb84": n + 1, "framestack_push": n,
            "gae": PIX_PPO_STEPS}
    if launches != want:
        raise AssertionError(f"pixel PPO launch counts {launches}, want {want}")
    rec = records[-1]
    for k, v in rec.items():
        if not np.isfinite(v):
            raise AssertionError(f"pixel PPO metric {k} is not finite: {v}")
    start = load_flat(PIX_PPO_INIT)
    trained = to_flax_params(ts.net.state_dict(), "atari_actor_critic")
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in start}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"some parameters did not move: {moved}")
    steps = []
    for i in range(PIX_PPO_STEPS):
        split = {"rollout_ms": events["start"][i].elapsed_time(events["rollout"][i]),
                 "gae_ms": events["rollout"][i].elapsed_time(events["gae"][i]),
                 "update_ms": events["gae"][i].elapsed_time(events["update"][i])}
        split["step_ms"] = events["start"][i].elapsed_time(events["update"][i])
        split["env_steps_per_s"] = PIX_PPO_ENVS * PIX_PPO_T / (split["step_ms"] * 1e-3)
        steps.append(split)
    obs = ts.last_obs
    with torch.no_grad():
        policy_ms = device_ms(lambda: ts.net(obs), 20)
        policy_call = call_ms(lambda: ts.net(obs), 20)
    emit({"phase": "pixel_ppo_train", "n_envs": PIX_PPO_ENVS, "rollout_len": PIX_PPO_T,
          "frame_stack": PIX_PPO_K, "train_steps": PIX_PPO_STEPS, "record": rec,
          "launches": launches, "wall_s_with_setup": wall, "steps": steps,
          "policy_forward_device_ms": policy_ms, "policy_forward_call_ms": policy_call,
          "param_max_change": moved, "peak_mem_gib": peak / 2**30,
          "rollout_obs_gib": PIX_PPO_T * PIX_PPO_ENVS * PIX_PPO_K * 84 * 84 / 2**30,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    evals = {}
    for name, net in (("untrained", load_actor_critic(PIX_PPO_INIT, device=dev)), ("trained", ts.net)):
        kernels.reset_launches()
        evals[name] = evaluate_policy(greedy_logits(net), EVAL_EPISODES, EngineConfig(),
                                      prng_key(EVAL_SEED), impl="flagship",
                                      max_steps=EVAL_MAX_STEPS, frame_stack=PIX_PPO_K, obs="rgb84",
                                      device=dev)
        torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)  # the trained net's evaluation
    it = evals["trained"]["iterations"]
    want = {**{k: 0 for k in launches}, "flagship_init": 1, "flagship_step": it,
            "render_rgb84": it + 1, "framestack_push": it}
    if eval_launches != want:
        raise AssertionError(f"pixel PPO evaluation launch counts {eval_launches}, want {want}")
    for name, st in evals.items():
        for k, v in st.items():
            if v != v or abs(v) == float("inf"):
                raise AssertionError(f"pixel PPO evaluation ({name}): {k} is not finite: {v}")
    emit({"phase": "pixel_ppo_eval", "episodes": EVAL_EPISODES, "max_steps": EVAL_MAX_STEPS,
          "frame_stack": PIX_PPO_K, **evals, "launches_trained": eval_launches,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    return {"launches": launches, "steps": steps, "ts": ts}


def pixel_ppo_path_kernels(dev, smi, ts) -> dict:
    """Phase 46: the pixel PPO path's kernels at its batch (B = 2048; T = 128
    for ``gae``) on its trained state, bit-equal to their plain versions
    (``ppo_sample``'s log-probs within ``LOG_PROB_ULPS``; every
    ``flagship_step`` build, with the sample as the path launches it and
    without), then their device ms beside their bounds, the launch floor and
    plain versions, each ``flagship_step`` build's, and the sampling step
    beside the two launches it replaces (``ppo_sample`` then
    ``flagship_step``)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops import framestack, threefry
    from tetris_gymnasium_torch.rl import ppo

    t0 = time.perf_counter()
    B, T = PIX_PPO_ENVS, PIX_PPO_T
    cfg = EngineConfig(auto_reset=True)
    ppo_cfg = ppo.PPOConfig(rollout_len=T, frame_stack=PIX_PPO_K)
    window, s = ts.last_obs, ts.env_states
    with torch.no_grad():
        logits = ts.net(window)[0]
    key = threefry.fold_in(threefry.prng_key(46), 0)
    a, lp = kernels.sample_actions(logits, key)
    pa, plp = ppo.sample_actions_plain(logits, key)
    diff("ppo_sample", a, pa, "pixel PPO actions")
    err = (lp.double() - plp.double()).abs()
    MAX_ERR["ppo_sample"] = max(MAX_ERR["ppo_sample"], float(err.max()))
    ulp = torch.from_numpy(np.spacing(plp.abs().cpu().numpy())).to(dev).double()
    if bool((err > 2.0**-22 + LOG_PROB_ULPS * ulp).any()):
        raise AssertionError(f"pixel PPO log_prob: max error {float(err.max())}")
    ks, kr, kd, kl = flagship_builds_diff([(s, a)], cfg, engine.PIECES, RewardsMapping(),
                                          engine.step_plain(s, a, cfg), "pixel PPO step")[0]
    for off in (0, 3 * B):
        flagship_sample_diff(s, logits, key, cfg, engine.PIECES, RewardsMapping(),
                             "pixel PPO sampling step", off)
    raw = kernels.render_rgb84(ks, cfg, engine.PIECES)
    diff("render_rgb84", raw, engine.render_rgb84_plain(ks, cfg), "pixel PPO frame")
    diff("framestack_push", kernels.framestack_push(window, raw, kd),
         framestack.push_plain(window, raw, kd), "pixel PPO window push")
    # gae on one more rollout of the trained policy, the path's own inputs
    traj, _, last_obs, _ = ppo.rollout(ts, ppo_cfg, ppo.sample_step_fn(cfg, "flagship", obs="rgb84"))
    with torch.no_grad():
        last_value = ts.net(last_obs)[1]
    reward, value, done = traj.reward.contiguous(), traj.value.contiguous(), traj.done.contiguous()
    del traj, last_obs
    torch.cuda.empty_cache()
    got = kernels.gae(reward, value, done, last_value, ppo_cfg.gamma, ppo_cfg.gae_lambda)
    plain = ppo.gae_plain(reward, value, done, last_value, ppo_cfg.gamma, ppo_cfg.gae_lambda)
    diff("gae", got[0], plain[0], "pixel PPO advantages")
    diff("gae", got[1], plain[1], "pixel PPO targets")
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0

    kept = (B - int(kd.sum())) * nbytes(window[0, 1:])
    state_bytes = nbytes(*(getattr(s, k) for k in engine.FIELDS))
    entries = {
        "ppo_sample": (lambda: kernels.sample_actions(logits, key),
                       lambda: ppo.sample_actions_plain(logits, key), nbytes(logits) + B * (4 + 4),
                       SAMPLE_OPS_PER_ELEMENT * B * 8),
        "flagship_step": (lambda: kernels.flagship_step(s, a, cfg, engine.PIECES, RewardsMapping()),
                          lambda: engine.step_plain(s, a, cfg),
                          2 * state_bytes + nbytes(a) + B * (4 + 1 + 4),
                          B * FLAGSHIP_STEP_OPS_PER_ENV),
        # the path's launch: the action sampled in the step's launch
        "flagship_step_sample": (
            lambda: kernels.flagship_step(s, None, cfg, engine.PIECES, RewardsMapping(), logits=logits,
                                          act_key=key),
            lambda: engine.step_plain(s, ppo.sample_actions_plain(logits, key)[0], cfg),
            2 * state_bytes + B * (4 + 1 + 4) + nbytes(logits) + B * (4 + 4),
            B * (FLAGSHIP_STEP_OPS_PER_ENV + 8 * SAMPLE_OPS_PER_ELEMENT)),
        "render_rgb84": (lambda: kernels.render_rgb84(ks, cfg, engine.PIECES),
                         lambda: engine.render_rgb84_plain(ks, cfg), _render_bytes(ks, B),
                         B * render_ops(cfg.padded_height)),
        "framestack_push": (lambda: kernels.framestack_push(window, raw, kd),
                            lambda: framestack.push_plain(window, raw, kd),
                            kept + nbytes(raw, kd, window), 0),
        "gae": (lambda: kernels.gae(reward, value, done, last_value, ppo_cfg.gamma,
                                    ppo_cfg.gae_lambda),
                lambda: ppo.gae_plain(reward, value, done, last_value, ppo_cfg.gamma,
                                      ppo_cfg.gae_lambda),
                nbytes(reward, value, done, last_value) + 2 * nbytes(reward),
                GAE_OPS_PER_ELEMENT * T * B),
    }
    out = {}
    for name, (kernel_fn, plain_fn, io, ops) in entries.items():
        out[name] = timed_pair(kernel_fn, plain_fn, 100, 3 if name in ("gae", "render_rgb84") else 10,
                               io, ops)
        out[name]["library_ms"] = None  # no one PyTorch call computes any of these
    out["gae"]["build"] = kernels.gae_build(B, reward, value, done, reward, value)
    out["flagship_step"]["lanes"] = kernels.flagship_step_lanes(B, cfg.padded_height)
    out["flagship_step"]["builds_ms"] = {
        lanes: device_ms(lambda: kernels.flagship_step(s, a, cfg, engine.PIECES, RewardsMapping(),
                                                       lanes=lanes), 100)
        for lanes in kernels.FLAGSHIP_LANES}
    out["flagship_step"]["builds_ms"].update({
        f"{lanes}+sample": device_ms(lambda: kernels.flagship_step(
            s, None, cfg, engine.PIECES, RewardsMapping(), lanes=lanes, logits=logits, act_key=key), 100)
        for lanes in kernels.FLAGSHIP_LANES})
    out["flagship_step_sample"]["lanes"] = out["flagship_step"]["lanes"]
    out["ppo_sample_then_flagship_step"] = {"ms": device_ms(lambda: kernels.flagship_step(
        s, kernels.sample_actions(logits, key)[0], cfg, engine.PIECES, RewardsMapping()), 100)}
    out["render_rgb84"]["bound_ms_2d"] = _bound(
        _render_bytes(ks, B), B * 84 * 84 * RENDER_OPS_PER_PIXEL_2D)["bound_ms"]
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    for v in out.values():
        v["floor_ms"] = floor_ms
    emit({"phase": "pixel_ppo_kernels", "B": B, "T": T, "bit_equal": True,
          "log_prob_bit_equal_plain": bool(torch.equal(bits(lp), bits(plp))),
          "episodes_ended": int(kd.sum()), "rollout_done_share": float(done.float().mean()),
          "check_seconds": checked_s, "kernels": out, "nvidia_smi": smi})
    return out


def check_ppo_curve(dev, smi) -> dict:
    """Phase 47: the board PPO trainer from the JAX run's initial weights at
    the settings of ``results/ppo.jsonl``, held to that record."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.examples import train_ppo

    with open(PPO_CURVE) as f:
        record = {r["iteration"]: r for r in map(json.loads, f)}
    if record[1]["env_steps"] != 2048 * 128:
        raise AssertionError(f"{PPO_CURVE} is not a 2048 x 128 run: {record[1]}")
    args = train_ppo.parse_args(CURVE_ARGV)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, records = train_ppo.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {r["iteration"]: r for r in records}
    first, last = got[1]["reward_per_step"], got[CURVE_ITERATIONS]["reward_per_step"]
    want_first = record[1]["reward_per_step"]
    result = {"phase": "ppo_curve", "iterations": CURVE_ITERATIONS, "wall_s_with_setup": wall,
              "reward_per_step": {i: r["reward_per_step"] for i, r in got.items()},
              "record_reward_per_step": {i: record[i]["reward_per_step"] for i in got},
              "steps_per_episode": {i: r["steps_per_episode"] for i, r in got.items()},
              "record_steps_per_episode": {i: record[i]["steps_per_episode"] for i in got},
              "ratio": last / first, "record_ratio": record[CURVE_ITERATIONS]["reward_per_step"] / want_first,
              "gate": CURVE_GATE, "start_tol": CURVE_START_TOL, "launches": dict(kernels.LAUNCHES),
              "nvidia_smi": smi}
    emit(result)
    if abs(first - want_first) > CURVE_START_TOL:
        raise AssertionError(f"PPO curve: iteration 1 gives {first} reward per step, the record "
                             f"{want_first}; want within {CURVE_START_TOL}")
    if not last >= CURVE_GATE * first:
        raise AssertionError(f"PPO curve: iteration {CURVE_ITERATIONS} gives {last} reward per "
                             f"step, {last / first:.3f}x iteration 1's; want {CURVE_GATE}x")
    return result


# ---------------------------------------------------------------------------
# 48.-51. multi-device: the env-sharded rollout, PPO and DQN over torch.distributed
# ---------------------------------------------------------------------------

OFFSET_B = (2048, 8192)  # the flagship PPO's and the main path's batch
ROLLOUT = dict(n_envs=65536, horizon=256, repeats=4)  # the JAX launcher's defaults
FN_ROLLOUT = dict(n_envs=65536, horizon=64, repeats=1)
SHARD_DQN_ENVS, SHARD_PPO_ENVS, SHARD_ITERS = 65536, 8192, 3
SHARD_TRAIN = dict(rollout_len=TRAIN_T, update_epochs=6, n_minibatches=8, learning_rate=4e-5,
                   ent_coef=0.004)  # phase 9's PPOConfig (TRAIN_ARGV)
# Phase 50: the first train step's last-minibatch loss terms, sharded
# against unsharded, within this share of max(|term|, 1) (pg_loss is a mean
# of unit-scale normalised advantages, near 0): the update's float32 sums
# run in another order on each world size, and Adam magnifies that over the
# step's 48 minibatches (5e-4 of v_loss at W = 1, 1.7e-3 at W = 2 in this
# phase on an H100 80GB HBM3 at 700 W)
SHARD_LOSS_TOL = 5e-3
WORKER_TIMEOUT_S = 600
# the groups a sharded phase runs in: (world size, launcher backend)
GROUPS = ((1, "auto"), (2, "gloo-cuda"))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_offset_kernels(dev, smi) -> dict:
    """Phase 48: ``ppo_sample``, ``turbo_step``'s and ``flagship_step``'s
    sampling builds (each lanes build) and ``dqn_act`` at B = 2048 and 8192
    and the global counter offsets 0, B and 3B: each bit-equal to its plain
    version at the same offset and to the slice ``[offset, offset + B)`` of
    one launch over 4B envs; then their times at offsets 0 and 3B."""
    import dataclasses

    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.rl import dqn, ppo

    g = torch.Generator(device=dev)
    g.manual_seed(48)
    cfg, rw = EngineConfig(auto_reset=True), RewardsMapping()
    key, eps_key = prng_key(11), prng_key(12)
    checked, times = 0, {}
    for B in OFFSET_B:
        full = 4 * B
        logits = torch.randn((full, 8), generator=g, device=dev) * 3
        q = torch.randn((full, 8), generator=g, device=dev)
        s = kernels.turbo_init(batch_keys(prng_key(13), full, device=dev), cfg, turbo.PIECES)
        for _ in range(30):  # a state in mid-game
            a = torch.randint(0, 8, (full,), generator=g, device=dev, dtype=torch.int32)
            s = kernels.turbo_step(s, a, cfg, turbo.PIECES, rw)[0]
        obs_full = torch.empty((full, cfg.height, cfg.width), dtype=torch.int8, device=dev)
        fs = kernels.flagship_init(batch_keys(prng_key(14), full, device=dev), cfg, engine.PIECES)
        for _ in range(30):
            fs = kernels.flagship_step(fs, _flagship_actions(full, g, dev), cfg, engine.PIECES, rw)[0]
        whole = {
            "ppo_sample": kernels.sample_actions(logits, key),
            "turbo_step": kernels.turbo_step(s, None, cfg, turbo.PIECES, rw, obs=obs_full,
                                             logits=logits, act_key=key),
            "flagship_step": kernels.flagship_step(fs, None, cfg, engine.PIECES, rw, logits=logits,
                                                   act_key=key),
            "dqn_act": kernels.dqn_act(q, key, eps_key, 0.5, return_draws=True),
        }
        for off in (0, B, 3 * B):
            x, qx = logits[off:off + B].contiguous(), q[off:off + B].contiguous()
            part = dataclasses.replace(s, **{k: getattr(s, k)[..., off:off + B].contiguous()
                                             for k in turbo.FIELDS})
            what = f"B={B} offset={off}"
            got = kernels.sample_actions(x, key, env_offset=off)
            plain = ppo.sample_actions_plain(x, key, off)
            for i, name in enumerate(("action", "log_prob")):
                diff("ppo_sample", got[i], plain[i], f"ppo_sample {what} {name} vs plain")
                diff("ppo_sample", got[i], whole["ppo_sample"][i][off:off + B],
                     f"ppo_sample {what} {name} vs the full launch")
            pa, plp = plain
            ps, pr, pd, pl = turbo.step_plain(part, pa, cfg, rewards=rw)
            pobs = turbo.observe_board_plain(ps, cfg)
            ws, wr, wd, wl, wa, wlp = whole["turbo_step"]
            for lanes in (None,) + tuple(kernels.STEP_LANES):
                obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
                ks, kr, kd, kl, ka, klp = kernels.turbo_step(
                    part, None, cfg, turbo.PIECES, rw, obs=obs, lanes=lanes, logits=x,
                    act_key=key, env_offset=off)
                tag = f"turbo_step sample {what} lanes={lanes}"
                for k in turbo.FIELDS:
                    diff("turbo_step", getattr(ks, k), getattr(ps, k), f"{tag} {k} vs plain")
                    diff("turbo_step", getattr(ks, k), getattr(ws, k)[..., off:off + B],
                         f"{tag} {k} vs the full launch")
                for name, a1, a2, a3 in (("reward", kr, pr, wr), ("done", kd, pd, wd),
                                         ("lines", kl, pl, wl), ("action", ka, pa, wa),
                                         ("log_prob", klp, plp, wlp), ("obs", obs, pobs, obs_full)):
                    diff("turbo_step", a1, a2, f"{tag} {name} vs plain")
                    diff("turbo_step", a1, a3[off:off + B], f"{tag} {name} vs the full launch")
            fpart = fs.replace(**{k: (getattr(fs, k)[:, off:off + B] if k == "key"
                                      else getattr(fs, k)[off:off + B]).contiguous()
                                  for k in engine.FIELDS})
            fps, fpr, fpd, fpl = engine.step_plain(fpart, pa, cfg, rewards=rw)
            fws, fwr, fwd, fwl, fwa, fwlp = whole["flagship_step"]
            for lanes in (None,) + tuple(kernels.FLAGSHIP_LANES):
                ks, kr, kd, kl, ka, klp = kernels.flagship_step(
                    fpart, None, cfg, engine.PIECES, rw, lanes=lanes, logits=x, act_key=key,
                    env_offset=off)
                tag = f"flagship_step sample {what} lanes={lanes}"
                for k in engine.FIELDS:
                    got = getattr(ks, k)
                    cut = getattr(fws, k)[:, off:off + B] if k == "key" else getattr(fws, k)[off:off + B]
                    diff("flagship_step", got, getattr(fps, k), f"{tag} {k} vs plain")
                    diff("flagship_step", got, cut, f"{tag} {k} vs the full launch")
                for name, a1, a2, a3 in (("reward", kr, fpr, fwr), ("done", kd, fpd, fwd),
                                         ("lines", kl, fpl, fwl), ("action", ka, pa, fwa),
                                         ("log_prob", klp, plp, fwlp)):
                    diff("flagship_step", a1, a2, f"{tag} {name} vs plain")
                    diff("flagship_step", a1, a3[off:off + B], f"{tag} {name} vs the full launch")
            checked += dqn_act_builds_diff(qx, key, eps_key, f"phase 48 {what}", offsets=(off,))
            got = kernels.dqn_act(qx, key, eps_key, 0.5, return_draws=True, env_offset=off)
            diff("dqn_act", got[0], dqn.act_plain(qx, key, eps_key, 0.5, env_offset=off),
                 f"dqn_act {what} vs plain")
            for i, name in enumerate(("action", "randint", "uniform")):
                diff("dqn_act", got[i], whole["dqn_act"][i][off:off + B],
                     f"dqn_act {what} {name} vs the full launch")
            checked += 1
        # times at offsets 0 and 3B, the kernels as the paths launch them
        s_b = dataclasses.replace(s, **{k: getattr(s, k)[..., :B].contiguous()
                                        for k in turbo.FIELDS})
        f_b = fs.replace(**{k: (getattr(fs, k)[:, :B] if k == "key" else getattr(fs, k)[:B]).contiguous()
                            for k in engine.FIELDS})
        x, qx = logits[:B].contiguous(), q[:B].contiguous()
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
        step_io = (2 * nbytes(*(getattr(s_b, k) for k in turbo.FIELDS)) + B * (4 + 1 + 4)
                   + nbytes(obs))
        fstep_io = 2 * nbytes(*(getattr(f_b, k) for k in engine.FIELDS)) + B * (4 + 1 + 4)
        sample_io = nbytes(x) + B * (4 + 4)
        for off in (0, 3 * B):
            fns = {
                "ppo_sample": (lambda: kernels.sample_actions(x, key, env_offset=off),
                               lambda: ppo.sample_actions_plain(x, key, off), sample_io,
                               SAMPLE_OPS_PER_ELEMENT * B * 8),
                "turbo_step_sample": (
                    lambda: kernels.turbo_step(s_b, None, cfg, turbo.PIECES, rw, obs=obs, logits=x,
                                               act_key=key, env_offset=off),
                    lambda: turbo.observe_board_plain(turbo.step_plain(
                        s_b, ppo.sample_actions_plain(x, key, off)[0], cfg)[0], cfg),
                    step_io + sample_io, SAMPLE_OPS_PER_ELEMENT * B * 8),
                "flagship_step_sample": (
                    lambda: kernels.flagship_step(f_b, None, cfg, engine.PIECES, rw, logits=x, act_key=key,
                                                  env_offset=off),
                    lambda: engine.step_plain(f_b, ppo.sample_actions_plain(x, key, off)[0], cfg),
                    fstep_io + sample_io, SAMPLE_OPS_PER_ELEMENT * B * 8),
                "dqn_act": (lambda: kernels.dqn_act(qx, key, eps_key, 0.5, env_offset=off),
                            lambda: dqn.act_plain(qx, key, eps_key, 0.5, env_offset=off),
                            nbytes(qx) + 4 * B, DQN_ACT_OPS_PER_ENV * B),
            }
            for name, (kernel_fn, plain_fn, io, ops) in fns.items():
                times.setdefault(name, {}).setdefault(B, {})[f"offset_{off}"] = {
                    **timed_pair(kernel_fn, plain_fn, 100, 10, io, ops), "offset": off}
        del s, s_b, fs, f_b, obs_full, whole
    emit({"phase": "offset_kernels", "bit_equal": True, "batches": list(OFFSET_B),
          "offsets": "0, B, 3B", "comparisons": checked, "times": times, "nvidia_smi": smi})
    return times


def _rollout_unsharded(dev, config, n_envs, horizon, repeats, engine_kind) -> dict:
    """JAX's ``launch.run`` sequence with no mesh at all: one batch of
    ``n_envs`` envs from keys ``fold_in(0, i)``, random actions ``randint``
    over the whole batch, the same keys as the sharded runs."""
    from tetris_gymnasium_torch.core import engine, fn_env
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.parallel.mesh import batch_keys, env_mesh, state_checksum

    keys = batch_keys(threefry.prng_key(0), n_envs, device=dev)
    if engine_kind == "fn_env":
        _, states, _ = fn_env.reset(keys, config, device=dev)
        step, n_actions, kw = fn_env.step, 7, {}
    else:
        states = engine.init(keys, config, device=dev)
        step, n_actions, kw = engine.step, 8, {"obs_fn": engine.no_obs}
    sum_r = torch.zeros((), dtype=torch.float64, device=dev)
    sum_d = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(1 + repeats):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        key = threefry.prng_key(1 + i)
        for _ in range(horizon):
            key, sub = threefry.split(key)
            a = threefry.randint_lanes(sub, n_envs, n_actions, dev).to(torch.int32)
            states, _, r, d, _ = step(states, a, config, **kw)
            sum_r += r.sum(dtype=torch.float64)
            sum_d += d.sum()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"steps_per_sec": n_envs * horizon * repeats / dt, "sum_reward": float(sum_r),
            "sum_done": int(sum_d), "checksum": state_checksum(states, env_mesh(dev))}


def env_hashes(state) -> list:
    """A fingerprint of each env of a turbo state: the wraparound sum of its
    words, each field weighted by another odd number."""
    from tetris_gymnasium_torch.core import turbo

    B = state.piece.shape[0]
    h = torch.zeros(B, dtype=torch.int64, device=state.piece.device)
    for i, k in enumerate(turbo.FIELDS):
        x = getattr(state, k)
        x = x.view(torch.int32) if x.dtype in (torch.uint32, torch.float32) else x
        h = (h + (2 * i + 1) * (x.reshape(-1, B).to(torch.int64) & 0xFFFFFFFF).sum(0)) & 0xFFFFFFFF
    return h.tolist()


def forward_batch_invariance(dev) -> list:
    """Whether a network's rows come out the same from one forward pass of
    B rows and from two of B / 2 (what each of two ranks runs): the
    sharded paths' trajectories equal the unsharded ones only where they
    do.  Raises unless they do at the shapes phases 49-51 run (the main
    path's 8192 and the DQN's 65536 envs); reports the rest."""
    from tetris_gymnasium_torch.models.networks import ActorCriticCNN, QNetworkCNN

    out = []
    gate = {("ActorCriticCNN", TRAIN_ENVS), ("QNetworkCNN", SHARD_DQN_ENVS)}
    for dtype in (torch.bfloat16, torch.float32):
        for cls, B in ((ActorCriticCNN, TRAIN_ENVS), (QNetworkCNN, SHARD_DQN_ENVS),
                       (ActorCriticCNN, 2048)):
            torch.manual_seed(0)
            net = cls(dtype=dtype).to(dev)
            g = torch.Generator(device=dev)
            g.manual_seed(1)
            x = torch.randint(-1, 2, (B, 20, 10), generator=g, device=dev).to(torch.int8)
            with torch.no_grad(), deterministic_cudnn():
                def first(y):
                    return y[0] if isinstance(y, tuple) else y
                whole = first(net(x))
                halves = torch.cat([first(net(x[:B // 2])), first(net(x[B // 2:]))])
            equal = torch.equal(whole, halves)
            out.append({"net": cls.__name__, "dtype": str(dtype), "B": B, "equal": equal,
                        "max_abs_diff": float((whole - halves).abs().max())})
            if (cls.__name__, B) in gate and not equal:
                raise AssertionError(f"{cls.__name__} at B = {B}: rows differ between one "
                                     f"forward and two halves: {out[-1]}")
    return out


def sharded_ppo_main(dev, mesh=None) -> dict:
    """Phase 50's run: the main path's PPO (``ActorCriticCNN`` on the turbo
    engine with board observations, phase 9's 8192 x 128, 6 epochs of 8
    minibatches, from ``results/ppo_lines_params.npz``) for ``TRAIN_STEPS``
    train steps under cuDNN's deterministic algorithms; sharded over
    ``mesh``, or with no mesh (today's unsharded path).  Returns each
    step's env checksum, loss terms and times (rollout, update and the
    collectives in it, by CUDA events), the final parameters' checksum and
    the launches."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import env_mesh, state_checksum
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    cfg = EngineConfig(auto_reset=True)
    pcfg = ppo.PPOConfig(**SHARD_TRAIN)
    events = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, []).append(ev)

    check_mesh = mesh or env_mesh(dev)
    steps = []
    with deterministic_cudnn():
        kernels.reset_launches()
        ts = ppo.init_train_state(prng_key(1), TRAIN_ENVS, cfg, pcfg, device=dev,
                                  params=load_flat(PARAMS), mesh=mesh)
        train_step = ppo.make_train_step(cfg, pcfg, marks=mark, mesh=mesh)
        for _ in range(TRAIN_STEPS):
            if mesh is not None:
                mesh.events = []
            ts, m = train_step(ts)
            torch.cuda.synchronize()
            i = len(steps)
            coll = mesh.collective_ms() if mesh is not None else 0.0
            steps.append({
                "rollout_ms": events["start"][i].elapsed_time(events["rollout"][i]),
                "update_ms": events["gae"][i].elapsed_time(events["update"][i]),
                "step_ms": events["start"][i].elapsed_time(events["update"][i]),
                "collective_ms": coll,
                "losses": {k: float(m[k]) for k in ("pg_loss", "v_loss", "entropy")},
                "env_checksum": state_checksum(ts.env_states, check_mesh),
                "env_hashes": env_hashes(ts.env_states)})
            if mesh is not None:
                mesh.events = None
    launches = dict(kernels.LAUNCHES)
    params = state_checksum(dict(ts.net.state_dict()), check_mesh, sharded=False)
    return {"steps": steps, "param_checksum": params, "launches": launches}


def rank_worker(spec_path: str) -> None:
    """One rank of phases 49-51 (``chip_smoke.py --rank-worker spec.json``):
    brings its process group up through the launcher, runs the sharded
    rollouts, the sharded main-path PPO and ``launch.main --train dqn`` and
    ``--train ppo``, and writes what each gave, with its launches, to the
    spec's ``out``."""
    sys.path.insert(0, REPO)
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, EnvConfig
    from tetris_gymnasium_torch.parallel import launch

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = ["--backend", spec["backend"], "--coordinator", f"localhost:{spec['port']}",
            "--num-processes", str(spec["world"]), "--process-id", str(spec["rank"]),
            "--timeout", "300"]
    mesh = launch.setup(launch.parse_args(base))
    dev = mesh.device
    out = {}

    def counted(name, fn):
        kernels.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        out[name] = {**result, "launches": dict(kernels.LAUNCHES)}

    counted("rollout", lambda: launch.run(mesh, EngineConfig(auto_reset=True), **ROLLOUT))
    counted("fn_rollout", lambda: launch.run(mesh, EnvConfig(), **FN_ROLLOUT, engine_kind="fn_env"))
    out["collectives_rollouts"] = dict(mesh.counts)
    ppo_main = sharded_ppo_main(dev, mesh)
    out["ppo_main"] = {**ppo_main, "collectives": dict(mesh.counts)}
    with deterministic_cudnn():  # so that a run repeats bit for bit
        counted("dqn", lambda: launch.main(base + ["--train", "dqn", "--n-envs",
                                                   str(SHARD_DQN_ENVS), "--train-iters",
                                                   str(SHARD_ITERS)]))
        counted("ppo_flagship", lambda: launch.main(
            base + ["--train", "ppo", "--n-envs", str(SHARD_PPO_ENVS), "--train-iters",
                    str(SHARD_ITERS)]))
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def run_groups(tmp: str) -> dict:
    """Each group of ``GROUPS`` in turn: its ranks started together as
    ``rank_worker`` processes; returns ``{world: [each rank's output]}``.
    A rank that fails or outlives ``WORKER_TIMEOUT_S`` fails the phase, and
    every process started here is ended."""
    results = {}
    for world, backend in GROUPS:
        port = _free_port()
        procs, outs = [], []
        for rank in range(world):
            spec = os.path.join(tmp, f"w{world}_r{rank}.json")
            out = os.path.join(tmp, f"w{world}_r{rank}_out.json")
            with open(spec, "w") as f:
                json.dump({"backend": backend, "port": port, "world": world, "rank": rank,
                           "out": out}, f)
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker", spec], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} of {world} ({backend}) exited "
                                     f"{p.returncode}:\n{log[-4000:]}")
        results[world] = []
        for out in outs:
            with open(out) as f:
                results[world].append(json.load(f))
    return results


def _same(what, values) -> None:
    """Raises unless every value of ``values`` (name -> value) is equal."""
    first_name, first = next(iter(values.items()))
    for name, v in values.items():
        if v != first:
            raise AssertionError(f"{what}: {name} gives {v}, {first_name} {first}")


def run_sharded(dev, smi) -> dict:
    """Phases 49-51: the sharded paths at world size 1 over NCCL and 2 over
    gloo on CUDA tensors (both ranks on this card), against the unsharded
    runs of the same keys in this process.

    49. ``launch.run`` at the JAX launcher's defaults (flagship, 65536 x
        256 x 4) and a compat rollout at 65536 x 64: checksums, Σreward and
        Σdone equal at W = 1, W = 2 and unsharded, on every rank.
    50. PPO on the main path (:func:`sharded_ppo_main`) unsharded, at W = 1
        and W = 2: each step's env checksum equal across the three and on
        every rank, the loss terms within ``SHARD_LOSS_RTOL`` of the
        unsharded run's, every rank's parameter checksum equal.
    51. ``launch.main --train dqn`` (65536 envs) and ``--train ppo``
        (flagship, 8192 envs), 3 iterations each: env and replay-buffer
        checksums equal at W = 1 and W = 2 and on every rank, and each
        world's ranks holding the same parameters.
    """
    import tempfile

    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, EnvConfig

    t0 = time.perf_counter()
    invariance = forward_batch_invariance(dev)
    ref = {"rollout": _rollout_unsharded(dev, EngineConfig(auto_reset=True), **ROLLOUT,
                                         engine_kind="engine"),
           "fn_rollout": _rollout_unsharded(dev, EnvConfig(), **FN_ROLLOUT, engine_kind="fn_env")}
    ref["ppo_main"] = sharded_ppo_main(dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        got = run_groups(tmp)
    wall = time.perf_counter() - t0

    # 49. the rollouts
    rollouts = {}
    for name in ("rollout", "fn_rollout"):
        for field in ("checksum", "sum_reward", "sum_done"):
            _same(f"{name} {field}", {"unsharded": ref[name][field],
                                      **{f"W={w} rank {i}": r[name][field]
                                         for w, rs in got.items() for i, r in enumerate(rs)}})
        if not ref[name]["sum_done"] > 0:
            raise AssertionError(f"{name}: no episode ended")
        rollouts[name] = {"unsharded_steps_per_s": ref[name]["steps_per_sec"],
                          **{f"w{w}_steps_per_s": rs[0][name]["steps_per_sec"]
                             for w, rs in got.items()},
                          "sum_reward": ref[name]["sum_reward"], "sum_done": ref[name]["sum_done"],
                          "launches_w1": got[1][0][name]["launches"]}
    emit({"phase": "sharded_rollout", "equal": True, "rollout": ROLLOUT, "fn_rollout": FN_ROLLOUT,
          "runs": rollouts, "collectives_w2": got[2][0]["collectives_rollouts"],
          "nvidia_smi": smi})

    # 50. PPO on the main path: the first step rolls out the same weights
    # everywhere, so its envs must agree bit for bit; the later steps roll
    # out each run's own update, which sums in another order (reported)
    runs = {"unsharded": ref["ppo_main"],
            **{f"W={w} rank {i}": r["ppo_main"] for w, rs in got.items() for i, r in enumerate(rs)}}
    hashes = {"unsharded": [s["env_hashes"] for s in ref["ppo_main"]["steps"]],
              **{f"W={w}": [sum((r["ppo_main"]["steps"][i]["env_hashes"] for r in rs), [])
                            for i in range(TRAIN_STEPS)] for w, rs in got.items()}}
    differing = {k: [int(sum(a != b for a, b in zip(h, hashes["unsharded"][i])))
                     for i, h in enumerate(v)] for k, v in hashes.items()}
    for w, rs in got.items():
        for i in range(TRAIN_STEPS):
            _same(f"sharded PPO W={w} step {i + 1} env checksum",
                  {f"rank {j}": r["ppo_main"]["steps"][i]["env_checksum"]
                   for j, r in enumerate(rs)})
    _same("sharded PPO step 1 env checksum",
          {k: v["steps"][0]["env_checksum"] for k, v in runs.items()})
    if any(d[0] for d in differing.values()):
        raise AssertionError(f"sharded PPO step 1: envs differing from unsharded {differing}")
    for term in ("pg_loss", "v_loss", "entropy"):
        want = ref["ppo_main"]["steps"][0]["losses"][term]
        for k, v in runs.items():
            have = v["steps"][0]["losses"][term]
            if not abs(have - want) <= SHARD_LOSS_TOL * max(abs(want), 1.0):
                raise AssertionError(f"sharded PPO step 1 {term}: {k} {have}, unsharded {want}")
            for step in v["steps"]:
                if not np.isfinite(step["losses"][term]):
                    raise AssertionError(f"sharded PPO {k} {term} is not finite: {step}")
    for w, rs in got.items():
        _same(f"W={w} PPO parameter checksum",
              {f"rank {i}": r["ppo_main"]["param_checksum"] for i, r in enumerate(rs)})
    want_launches = {**{k: 0 for k in kernels.LAUNCHES}, "turbo_init": 1, "observe_board": 1,
                     "turbo_step": TRAIN_STEPS * TRAIN_T, "turbo_step_obs": TRAIN_STEPS * TRAIN_T,
                     "turbo_step_sample": TRAIN_STEPS * TRAIN_T, "gae": TRAIN_STEPS}
    for k, v in runs.items():
        if v["launches"] != want_launches:
            raise AssertionError(f"sharded PPO {k}: launches {v['launches']}, want {want_launches}")
    ppo_main = {k: {"steps": [{f: s[f] for f in ("rollout_ms", "update_ms", "step_ms",
                                                   "collective_ms", "losses")} for s in v["steps"]]}
                for k, v in runs.items()}
    equal = [all(v["steps"][i]["env_checksum"] == ref["ppo_main"]["steps"][i]["env_checksum"]
                 for v in runs.values()) for i in range(TRAIN_STEPS)]
    emit({"phase": "sharded_ppo", "n_envs": TRAIN_ENVS, "rollout_len": TRAIN_T,
          "train_steps": TRAIN_STEPS, "env_checksums_equal_by_step": equal,
          "envs_differing_from_unsharded_by_step": differing, "runs": ppo_main,
          "collectives_w2": got[2][0]["ppo_main"]["collectives"],
          "forward_batch_invariance": invariance, "nvidia_smi": smi})

    # 51. the launcher's sharded DQN and flagship PPO
    train = {}
    for name, fields in (("dqn", ("env_checksum", "buffer_checksum")),
                         ("ppo_flagship", ("env_checksum",))):
        for field in fields:
            _same(f"launch --train {name} {field}",
                  {f"W={w} rank {i}": r[name][field] for w, rs in got.items()
                   for i, r in enumerate(rs)})
        for w, rs in got.items():
            _same(f"launch --train {name} W={w} param_checksum",
                  {f"rank {i}": r[name]["param_checksum"] for i, r in enumerate(rs)})
        train[name] = {f"w{w}": {k: rs[0][name][k] for k in rs[0][name]
                                 if k not in ("env_checksum", "buffer_checksum", "param_checksum")}
                       for w, rs in got.items()}
    emit({"phase": "sharded_train", "equal": True, "runs": train,
          "peak_mem_gib": {f"w{w}": [r["peak_mem_gib"] for r in rs] for w, rs in got.items()},
          "seconds": wall, "nvidia_smi": smi})
    return {"rollouts": rollouts, "ppo_main": ppo_main, "train": train,
            "launches": {f"{name}_w2": got[2][0][name]["launches"]
                         for name in ("rollout", "fn_rollout", "ppo_main", "dqn", "ppo_flagship")}}

# ---------------------------------------------------------------------------
# 52.-55. The utilities: video capture, checkpoint evaluation, whole-state
# checkpoints and the trainers' logging flags
# ---------------------------------------------------------------------------

VIDEO_SEEDS = (0, 1, 2, 3)
VIDEO_GEOMETRIES = (("10x20", {}), ("30x20", dict(width=30, height=20)))
VIDEO_MAX_STEPS = 400  # record_training_video's cap
OUT_DIR = os.path.join(REPO, "build", "chip_smoke_utils")  # gitignored
PHASE5_LINES_H100 = 10.6035  # phase 5's lines/episode, H100 80GB HBM3 at 700.00 W (PERF.md)
FLAG_ARGV = ["--n-envs", "2048", "--iterations", "2", "--seed", "1"]  # the JAX defaults, 2 iterations
RESUME_DQN_LEARNING_STARTS = 64  # Adam holds moments by the time the buffer is full


def _frame_launches(frames) -> dict:
    """A recorded episode's launches: per frame ``observe_dict`` and
    ``compose_rgb`` (the frame) and ``flagship_observe_board`` (the
    policy's board), per step ``flagship_step``, one ``flagship_init``."""
    from tetris_gymnasium_torch import kernels

    return {**{k: 0 for k in kernels.LAUNCHES}, "flagship_init": 1, "flagship_step": frames - 1,
            "flagship_observe_board": frames, "observe_dict": frames, "compose_rgb": frames}


def check_video(dev, smi) -> dict:
    """Phase 52: ``utils/video.py`` on the card.  The random policy's episodes
    at seeds 0-3 on the default board and at 30x20, bit-equal to the same
    calls on the CPU, with exact launches; one greedy episode of the
    committed PPO policy in fp32 under cuDNN's deterministic algorithms,
    its frames equal to the CPU's, written as a GIF under ``build/``."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.utils import video
    from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic

    def recorded(policy, cfg, seed, device):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = video.record_episode(policy, config=cfg, seed=seed, max_steps=VIDEO_MAX_STEPS,
                                      device=device)
        return frames, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    t_phase = time.perf_counter()
    runs = []
    for geo, kw in VIDEO_GEOMETRIES:
        cfg = EngineConfig(**kw)
        for seed in VIDEO_SEEDS:
            card, wall, launches = recorded(None, cfg, seed, dev)
            cpu = video.record_episode(config=cfg, seed=seed, max_steps=VIDEO_MAX_STEPS,
                                       device="cpu")
            if card.shape != cpu.shape or not np.array_equal(card, cpu):
                raise AssertionError(f"video {geo} seed {seed}: card frames differ from the CPU's")
            if launches != _frame_launches(len(card)):
                raise AssertionError(f"video {geo} seed {seed}: launches {launches}, want "
                                     f"{_frame_launches(len(card))}")
            runs.append({"geometry": geo, "seed": seed, "frames": len(card),
                         "frame_shape": list(card.shape[1:]), "host_ms_per_frame":
                         1e3 * wall / len(card), "launches": {k: v for k, v in launches.items() if v}})

    # a greedy episode of the committed policy; its actions replayed on the
    # CPU engine give its length and lines
    actions = []

    def logged(policy):
        def play(obs, key):
            a = policy(obs, key)
            actions.append(a)
            return a
        return play

    greedy = {}
    with deterministic_cudnn():
        for where in ("cuda", "cpu"):
            net = load_actor_critic(PARAMS, device=where, dtype=torch.float32)
            actions.clear()
            greedy[where] = recorded(logged(video.greedy_policy_fn(net)), EngineConfig(), 0, where)
    (card, wall, launches), (cpu, _, _) = greedy["cuda"], greedy["cpu"]
    if card.shape != cpu.shape or not np.array_equal(card, cpu):
        raise AssertionError("greedy video: card frames differ from the CPU's")
    if launches != _frame_launches(len(card)):
        raise AssertionError(f"greedy video: launches {launches}")
    cfg = EngineConfig()
    state = engine.init_state(threefry.fold_in(threefry.prng_key(0), 0), cfg, device="cpu")
    for a in actions:
        state = engine.step(state, torch.tensor([a], dtype=torch.int32), cfg,
                            obs_fn=engine.no_obs)[0]
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    path = video.write_video(card, os.path.join(OUT_DIR, "ppo_lines_seed0.gif"))
    write_s = time.perf_counter() - t0
    if not os.path.getsize(path) > 0:
        raise AssertionError(f"no GIF at {path}")
    out = {"phase": "video", "bit_equal_cpu": True, "runs": runs,
           "greedy": {"frames": len(card), "length": len(actions), "lines": int(state.lines[0]),
                      "score": float(state.score[0]), "game_over": bool(state.game_over[0]),
                      "host_ms_per_frame": 1e3 * wall / len(card), "gif": os.path.relpath(path, REPO),
                      "gif_bytes": os.path.getsize(path), "gif_write_s": write_s},
           "launches_per_frame": {"flagship_step": 1, "flagship_observe_board": 1,
                                  "observe_dict": 1, "compose_rgb": 1},
           "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(out)
    return {"launches": runs[0]["launches"] | {k: 0 for k in kernels.LAUNCHES
                                               if k not in runs[0]["launches"]},
            "frames": runs[0]["frames"]}


def check_evaluate_checkpoint(dev, smi, phase5_stats) -> dict:
    """Phase 53: ``examples/evaluate_checkpoint.py --net actor-critic`` on the
    committed policy (512 episodes, seed 0) prints exactly what
    ``rl.evaluate.main`` gives for the same arguments, rounded as the JAX
    example rounds; its launches are phase 5's."""
    import io

    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.examples import evaluate_checkpoint
    from tetris_gymnasium_torch.rl import evaluate

    argv = ["--checkpoint", PARAMS, "--episodes", str(EVAL_EPISODES), "--seed", str(EVAL_SEED)]
    printed = io.StringIO()
    with deterministic_cudnn():
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            got = evaluate_checkpoint.main(["--net", "actor-critic"] + argv)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with contextlib.redirect_stdout(io.StringIO()):
            want = evaluate.main(argv)
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    rounded = {k: round(float(v), 4) for k, v in want.items()}
    if not line == got == rounded:
        raise AssertionError(f"evaluate_checkpoint printed {line}, rl.evaluate.main gives {rounded}")
    it = want["iterations"]
    if launches != {**{k: 0 for k in launches}, "turbo_step": it, "turbo_step_obs": it,
                    "observe_board": 1, "turbo_init": 1}:
        raise AssertionError(f"evaluate_checkpoint launches {launches} for {it} iterations")
    emit({"phase": "evaluate_checkpoint", "equal_rl_evaluate_main": True, "printed": line,
          "phase5_lines_mean": phase5_stats["lines_mean"],
          "phase5_lines_h100_pr13": PHASE5_LINES_H100, "launches": launches, "seconds": wall,
          "nvidia_smi": smi})
    return {"launches": launches}


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _state_equal(what, a, b) -> None:
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"{what}: field {f} differs")


def _adam_equal(what, a, b) -> None:
    for i, (sa, sb) in enumerate(zip(a.state.values(), b.state.values())):
        for k in sb:
            if not torch.equal(sa[k], sb[k]):
                raise AssertionError(f"{what}: Adam {k} of parameter {i} differs")


def check_resume(dev, smi) -> dict:
    """Phase 54: ``utils/checkpoint.py`` at the main path's width.  PPO at
    8192 x 128 from the committed weights under cuDNN's deterministic
    algorithms: run A takes a train step, saves the whole ``TrainState``
    and takes another; run B restores it into a freshly built template and
    takes one step.  A's second step and B's step must be bit-equal: the env
    batch (``state_checksum`` and every field), every parameter and Adam's
    moments.  Then a CNN DQN state (K = 4) with its full 262,144-entry
    replay buffer round-trips, and one more step from each copy is equal."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.examples import train_cnn, train_ppo
    from tetris_gymnasium_torch.parallel.mesh import env_mesh, state_checksum
    from tetris_gymnasium_torch.utils import checkpoint

    os.makedirs(OUT_DIR, exist_ok=True)
    args = train_ppo.parse_args(TRAIN_ARGV)
    io_s = {}
    with deterministic_cudnn():
        ts, train_step, _ = train_ppo.setup(args)
        ts, _ = train_step(ts)
        path = os.path.join(OUT_DIR, "ppo_state")
        _, io_s["ppo_save_s"] = _timed(lambda: checkpoint.save(path, ts))
        io_s["ppo_bytes"] = _dir_bytes(path)
        a, ma = train_step(ts)
        template, _, _ = train_ppo.setup(args)
        b0, io_s["ppo_restore_s"] = _timed(lambda: checkpoint.restore(path, template))
        kernels.reset_launches()
        b, mb = train_step(b0)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    mesh = env_mesh(dev)
    checksums = [state_checksum(s.env_states, mesh) for s in (a, b)]
    if checksums[0] != checksums[1]:
        raise AssertionError("resumed PPO: the env batch's checksum differs")
    _state_equal("resumed PPO env batch", a.env_states, b.env_states)
    for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        if not torch.equal(x, y):
            raise AssertionError(f"resumed PPO: parameter {k} differs")
    _adam_equal("resumed PPO", a.optimizer.adam, b.optimizer.adam)
    if not (np.array_equal(a.key, b.key) and {k: float(v) for k, v in ma.items()}
            == {k: float(v) for k, v in mb.items()}):
        raise AssertionError("resumed PPO: key or metrics differ")
    want = {**{k: 0 for k in launches}, "turbo_step": TRAIN_T, "turbo_step_obs": TRAIN_T,
            "turbo_step_sample": TRAIN_T, "gae": 1}
    if launches != want:
        raise AssertionError(f"resumed PPO step launches {launches}, want {want}")

    # the CNN DQN (phase 19's K = 4 shape) once its buffer is full
    dargv = dqn_argv(4)
    dargv[dargv.index("--learning-starts") + 1] = str(RESUME_DQN_LEARNING_STARTS)
    dargs = train_cnn.parse_args(dargv)
    with deterministic_cudnn():
        ds, dstep, _, dcfg = train_cnn.setup(dargs)
        while ds.buffer.size < ds.buffer.capacity:
            ds, _ = dstep(ds)
        dpath = os.path.join(OUT_DIR, "dqn_state")
        _, io_s["dqn_save_s"] = _timed(lambda: checkpoint.save(dpath, ds))
        io_s["dqn_bytes"] = _dir_bytes(dpath)
        dtemplate = train_cnn.setup(dargs)[0]
        back, io_s["dqn_restore_s"] = _timed(lambda: checkpoint.restore(dpath, dtemplate))
        for k, v in ds.buffer.data.items():
            if not torch.equal(back.buffer.data[k], v):
                raise AssertionError(f"DQN round trip: buffer field {k} differs")
        if (back.buffer.pos, back.buffer.size, back.step) != (ds.buffer.pos, ds.buffer.size, ds.step):
            raise AssertionError("DQN round trip: buffer position, size or step differs")
        _state_equal("DQN round trip env batch", back.env_states, ds.env_states)
        if not torch.equal(bits(back.obs), bits(ds.obs)):
            raise AssertionError("DQN round trip: the window differs")
        _adam_equal("DQN round trip", back.optimizer, ds.optimizer)
        da, ma = dstep(ds)
        db, mb = dstep(back)
    for net in ("net", "target_net"):
        for x, y in zip(getattr(da, net).parameters(), getattr(db, net).parameters()):
            if not torch.equal(x, y):
                raise AssertionError(f"DQN: one step after the round trip, {net} differs")
    if float(ma["loss"]) != float(mb["loss"]):
        raise AssertionError("DQN: one step after the round trip, the loss differs")
    emit({"phase": "resume", "ppo_bit_equal": True, "n_envs": TRAIN_ENVS, "rollout_len": TRAIN_T,
          "env_checksum": checksums[1], "launches_resumed_step": launches,
          "dqn_round_trip_equal": True, "dqn_buffer_entries": ds.buffer.capacity,
          "dqn_step": ds.step, **io_s,
          "ppo_save_mb_per_s": io_s["ppo_bytes"] / io_s["ppo_save_s"] / 1e6,
          "dqn_save_mb_per_s": io_s["dqn_bytes"] / io_s["dqn_save_s"] / 1e6,
          "dqn_restore_mb_per_s": io_s["dqn_bytes"] / io_s["dqn_restore_s"] / 1e6,
          "nvidia_smi": smi})
    return {"launches": launches, "ts": b, "train_step": train_step}


def check_trainer_flags(dev, smi, ts, train_step) -> dict:
    """Phase 55: the trainers' new flags on the card.  ``train_ppo --n-envs
    2048 --iterations 2 --video-every 1 --wandb`` (wandb hidden: this
    machine has no network, and ``wandb.init`` would try its server) writes
    two GIFs and prints one "wandb requested" warning, and its JSONL
    without ``sps`` equals a run without the two flags.  Then one main-path
    train step inside ``profiling.trace``: the trace holds CUDA kernel
    events of ``turbo_step`` and ``gae`` (how many of the step's 128 and 1
    launches it holds is reported)."""
    import io

    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.examples import train_ppo
    from tetris_gymnasium_torch.utils import profiling

    os.makedirs(OUT_DIR, exist_ok=True)
    logs = {name: os.path.join(OUT_DIR, f"{name}.jsonl") for name in ("flags", "plain")}
    for f in os.listdir(OUT_DIR):
        if f.startswith(("flags", "plain")):
            os.remove(os.path.join(OUT_DIR, f))
    err, out, saved = io.StringIO(), io.StringIO(), sys.modules.get("wandb")
    sys.modules["wandb"] = None  # forces the tracker's ImportError
    try:
        with deterministic_cudnn(), contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            train_ppo.main(FLAG_ARGV + ["--video-every", "1", "--wandb", "--log-json", logs["flags"]])
            flagged_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            train_ppo.main(FLAG_ARGV + ["--log-json", logs["plain"]])
            plain_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
    warnings = err.getvalue().count("wandb requested")
    if warnings != 1:
        raise AssertionError(f"{warnings} 'wandb requested' warnings, want 1: {err.getvalue()!r}")
    gifs = [os.path.join(OUT_DIR, f"flags_it{it}.gif") for it in (1, 2)]
    if not all(os.path.isfile(g) and os.path.getsize(g) > 0 for g in gifs):
        raise AssertionError(f"missing GIFs: {gifs}")

    def records(path):
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "sps"} for line in f]

    # train_ppo logs iteration 1 and every fifth: one record here
    if records(logs["flags"]) != records(logs["plain"]) or len(records(logs["plain"])) != 1:
        raise AssertionError(f"--video-every --wandb changed the records: {records(logs['flags'])} "
                             f"against {records(logs['plain'])}")

    # the profiler may drop a kernel record (CUPTI's buffers; PR 14 saw 127
    # of 128 once), so the trace must name both kernels, and the wrappers'
    # counts say how many launches there were
    trace_dir = os.path.join(OUT_DIR, "trace")
    kernels.reset_launches()
    with profiling.trace(trace_dir):
        ts, _ = train_step(ts)
    launched = {k: kernels.LAUNCHES[k] for k in ("turbo_step", "gae")}
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(f"{k}_kernel" in n for n in kernel_names) for k in ("turbo_step", "gae")}
    if not (found["turbo_step"] >= 1 and found["gae"] >= 1):
        raise AssertionError(f"trace kernel events {found}: turbo_step and gae must both show")
    if launched != {"turbo_step": TRAIN_T, "gae": 1}:
        raise AssertionError(f"the traced step launched {launched}")
    device_us = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel")
    emit({"phase": "trainer_flags", "wandb_warnings": warnings,
          "gifs": [os.path.relpath(g, REPO) for g in gifs],
          "gif_bytes": [os.path.getsize(g) for g in gifs], "records_equal": True,
          "seconds_with_flags": flagged_s, "seconds_without": plain_s,
          "trace_kernel_events": {"turbo_step": found["turbo_step"], "gae": found["gae"],
                                  "all": len(kernel_names)}, "traced_step_launches": launched,
          "trace_kernel_ms": device_us / 1e3, "nvidia_smi": smi})
    return {"trace_kernel_events": found}


# ---------------------------------------------------------------------------
# 56. The port's wheel
# ---------------------------------------------------------------------------

WHEEL_TREE = ("pyproject.toml", "README.md", "LICENSE", "tetris_gymnasium_tpu", "tetris_gymnasium_torch")


def check_wheel(smi) -> dict:
    """Phase 56: the wheel built from a copy of the tree under
    ``build/wheel_smoke/`` holds every kernel source; installed with
    ``--target``, ``tools/wheel_smoke_torch.py`` (in a subprocess whose
    working directory is outside the package, its cache inside
    ``build/wheel_smoke/``) builds ``fn_step`` from the installed ``csrc/``
    into the cache, launches it and holds it to ``step_plain``."""
    import zipfile

    from tetris_gymnasium_torch import kernels

    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "wheel_smoke")
    shutil.rmtree(root, ignore_errors=True)
    src, dist, site, run, cache = (os.path.join(root, d) for d in ("src", "dist", "site", "run", "cache"))
    for d in (src, run):
        os.makedirs(d)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in WHEEL_TREE:
        path = os.path.join(REPO, name)
        if os.path.isdir(path):
            shutil.copytree(path, os.path.join(src, name), ignore=ignore)
        else:
            shutil.copy(path, os.path.join(src, name))
    pip = [sys.executable, "-m", "pip"]
    subprocess.run(pip + ["wheel", ".", "--no-deps", "--no-build-isolation", "--no-index", "-q", "-w", dist],
                   cwd=src, check=True, capture_output=True, text=True, timeout=300)
    (wheel,) = [os.path.join(dist, f) for f in os.listdir(dist) if f.endswith(".whl")]
    names = set(zipfile.ZipFile(wheel).namelist())
    csrc = sorted(os.listdir(os.path.join(REPO, "tetris_gymnasium_torch", "csrc")))
    missing = [f for f in csrc if f"tetris_gymnasium_torch/csrc/{f}" not in names]
    if missing:
        raise AssertionError(f"the wheel lacks the kernel sources {missing}")
    subprocess.run(pip + ["install", "--no-deps", "--no-index", "-q", "--target", site, wheel],
                   cwd=root, check=True, capture_output=True, text=True, timeout=300)
    env = {k: v for k, v in os.environ.items() if k != kernels.BUILD_DIR_ENV}
    env.update(PYTHONPATH=site, XDG_CACHE_HOME=cache, HOME=os.path.join(root, "home"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "wheel_smoke_torch.py")], cwd=run,
                          env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or proc.stdout.splitlines()[-1:] != ["wheel smoke (torch) OK"]:
        raise AssertionError(f"the wheel smoke failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    facts = json.loads(proc.stdout.splitlines()[-2])
    want_dir = os.path.realpath(os.path.join(cache, "tetris_gymnasium_torch", "kernels"))
    if os.path.realpath(facts["build_dir"]) != want_dir or not facts["library"].startswith(want_dir):
        raise AssertionError(f"the installed port built into {facts['build_dir']}, not {want_dir}")
    if os.path.realpath(facts["package"]) != os.path.realpath(os.path.join(site, "tetris_gymnasium_torch")):
        raise AssertionError(f"the smoke imported {facts['package']}, not the installed wheel")
    if facts.get("fn_step_equal_steps") != 32 or facts.get("fn_step_launches") != 32 or not facts["built"]:
        raise AssertionError(f"the installed fn_step did not build, launch and match: {facts}")
    out = {"phase": "wheel", "wheel": os.path.basename(wheel), "wheel_bytes": os.path.getsize(wheel),
           "csrc_files": len(csrc), **{k: facts[k] for k in ("build_dir", "build_seconds", "fn_step_launches",
                                                              "fn_step_equal_steps", "card")},
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(out)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(sys.argv[2])
    else:
        main()
