#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases card,kernels   # a subset, for bring-up

Phases:

1. card: the card's name and power limit, the torch and CUDA versions, TF32
   off for matmuls and cuDNN, and the build of the CUDA kernels from the
   sources in this checkout (``distributed_optimization_tpu_torch/csrc``),
   one nvcc per source, all started together.
2. kernels: each of the seven kernels against its plain PyTorch version on
   the card, in float32 and float64, with the largest difference, the
   median time of 200 launches from CUDA events, the plain version's time,
   one PyTorch library call computing the same function where there is one,
   and the bytes-or-operations bound; first the launch floor, an empty
   kernel through the same ctypes interface and a one-element ``torch.neg``,
   timed the same way (each record carries it as ``floor_ms``, and the
   empty kernel's time a launch inside a CUDA graph as ``graph_floor_ms``);
   at each kernel's path shape in float32, also the median time a launch
   takes inside a captured CUDA graph of 200 launches (``graph_ms``), as
   the run loop launches it:
   - ring kernels, bitwise, at N=256, d=81 (the main path), N=256, d=41 (the
     robust cell's benign mix), the JAX package's d-sweep at N=256 (d=128,
     256, 512, 1024), N=4096, d=1024 and the million-worker ring N=1,000,000,
     d=17 (library: ``torch.matmul``/``torch.addmm`` with the MH matrix,
     dense up to 1 GiB, else CSR through cuSPARSE);
   - fc kernels at N=25, d=81 (the fc path), N=256, d=41 (the
     robust_mixing path), N=256, d=81, N=4096, d=1024 and N=16384, d=1024
     (beyond the 50 MB L2), within N·ε·max|x| of the plain version and
     bitwise equal to the mirror of their summation order under the plan
     they launch with, which each line prints (library: the one reduction
     call, ``torch.mean``/``torch.sum`` over dim 0, which writes only d
     elements; the dense ``torch.matmul`` with W or A beside it up to
     N=4096); each line also gives the wall-clock time of one wrapper call
     in a loop of 200 with no sleep kernel ahead, host work included;
   - robust kernels, each rule (trimmed_mean, median, adaptive and fixed-τ
     clipped_gossip) with and without the SGD update, on the ring at N=256,
     d=41 (k_max=2), on a symmetric table with k_max=15 at N=4096,
     d=128, with about 20% of the slots dead and with every slot live, and
     on the robust phase's Erdős–Rényi table at N=64, d=81 (k_max=13, rows
     of 3 to 13 neighbours; each float32 line also timed in a graph):
     bitwise for the count rules, clipping within 1e-12 (rtol and atol) in
     float64 and, in float32, within 1e-5 of the largest |x| over each
     row's closed neighbourhood. No one PyTorch call computes a screen, so
     the library column is empty; the port's multi-op gather form is timed
     beside it;
   - the matrix-free fault form's kernels (``kernels_matrix_free``): the
     timeline's per-edge stream and the slot round (both dtypes, t inside,
     at and past the horizon; R = 4 replicas in one launch pair) bitwise
     their plain versions at the federated phase's cell (ii) (ER N=100,000,
     p = 16/N, the sparse sampler, 10% iid drops, participation 0.5; its
     records, the slot round's two launches also timed apart) and on the
     ring at N=256 (bursty drops, churn, participation; in the slot round's
     record as ``ring_256``), the slot round's live pass alone over a
     caller's tables (slots reordered, a masked hole) bitwise its plain
     version; and the dense round on the ring
     at N=65,537, whose counters i·N + j pass 2³², five rows bitwise the
     rows-only plain version.
3. sampling: the two sampling kernels (``ops/sampling_kernels.py``: the dense
   form's [N, L] weights, the gather form's [N, b] indices and weights and
   its gathered rows Xb [N, b, d] and yb [N, b]; one launch a gradient call,
   no pallas_call behind them) bitwise equal to the plain twin of
   ``ops/sampling.py`` in both dtypes (Xb and yb to ``gather_batches`` of
   the twin's indices, d=81), at the main path's
   input (N=256, L=49, b=16), the parity path's (N=25, L=500) and the robust
   cell's (N=256, L=50), each with shards of 0, 3 and b − 1 rows, seeds 0,
   42, 2³¹ − 1 (and 2⁴⁰ + 5 in float64), slots 0–2 and t = 0 and 2³¹ − 1;
   the known-answer digests of the JAX package's draws (``KNOWN_ANSWERS``,
   computed with jax 0.9.0) of the scores, weights and indices; and each
   kernel's times at its path's input beside its plain twin and its bound
   (Threefry rounds and a top-k selection over the INT32 rate), and
   ``torch.topk`` of the same scores in a graph as a yardstick of the
   selection alone; and the gather form's plan past 1,024 rows (L = 1,100
   and 7,000): one block with 8 rows a thread against a thread block
   cluster of a thread a row, both bitwise the twin, timed in turns; and a
   shard of 100,000 rows (``SAMPLING_LONG``, past the 65,536 a cluster holds
   in registers, where each pass recomputes the keys): the gather form
   bitwise the twin and the dense weights bitwise the twin's gather draw
   scattered, at N=1 and with ragged shards at N=4, both forms timed at
   N=1.
4. reference: small float64 runs on the card (fused ring kernel; ADMM
   through ``ring_neighbor_sum``; fused robust kernel under sign-flip with
   trimmed_mean and clipped_gossip) against the same runs on the CPU (plain
   versions): gap histories and final models must agree to 1e-12, since the
   sampler (the twin of ``jax.random`` on the CPU, its kernel on the card)
   gives both the same batches.
5. parity: the reference study's N=25 ring (logistic, T=10,000, float32,
   ``mixing_impl='pallas'``) must reach ε=0.08 within T; the fused kernel
   and the gather sampling kernel must launch exactly T times. The same run with
   ``measure_timestamps=True`` (the chunks from the host, no CUDA graph)
   must give bitwise the graph run's gap history, final models and launch
   counts; both runs' iters/s are printed.
6. main: the N=256 ring (dense-weights sampling, eval every iteration,
   T=30,000) with ``mixing_impl='pallas'`` and with ``'stencil'``; each must
   stay finite, cross ε=0.08 within T and end with consensus below 1.0, and
   launch the dense sampling kernel exactly T times;
   and the pallas run with ``measure_timestamps=True``, bitwise as in
   parity.
7. mixing: the pallas ``MixingOp`` (``ring_mix``, ``ring_neighbor_sum``)
   applied to the main run's final models, against the dense W and A.
8. fc: the reference study's fully-connected N=25 row (T=10,000, float32,
   ``mixing_impl='pallas'``): ε=0.08 within T, ``fc_mix`` launched exactly
   T times, bitwise its ``measure_timestamps=True`` run as in parity, and
   the stencil run's gap history within 1e-3 relative (float32
   rounding of two summation orders, accumulated over T steps); the same
   pair in float64 within 1e-10 relative, which shows that rounding is the
   whole of the float32 difference.
9. admm: decentralized ADMM (default c and ρ, float32, eval every
   iteration, T=2,000) on the main path's data at N=256 on the ring and at
   N=25 on the fully-connected graph, each with ``mixing_impl='pallas'`` and
   ``'stencil'``: every run crosses ε=0.08 within T, finite, with consensus
   below 1.0; the pallas runs launch ``ring_neighbor_sum`` /
   ``fc_neighbor_sum`` exactly T+1 times (init and every iteration) and no
   other ring or fc kernel; the ring pair's gap histories bitwise equal, the
   fc pair's within 1e-3 relative. The JAX package's CPU figures are printed
   beside (``ADMM_REFERENCE``), not gated on.
10. tracking: gradient tracking (T=3,000), EXTRA (T=3,000) and D-SGD with
   τ = 3 local steps (T=10,000) on the main path's data (N=256 ring,
   float32, eval every iteration), each with ``mixing_impl='pallas'`` and
   ``'stencil'``: iterations to ε within 1% of the JAX package's count at
   the same config (``TRACKING_RUNS``, jax 0.9.0; both packages draw the
   same batches); ``ring_mix`` 2T (GT) or T (EXTRA) times and
   ``fused_ring_dsgd_step`` T times (D-SGD) in the pallas runs, none in the
   stencil runs, the sampling kernel once a gradient call; the GT and EXTRA
   pallas runs bitwise their ``measure_timestamps=True`` runs; short
   float64 runs of each on the card against the CPU (1e-12); and GT under
   sign-flip with the fused trimmed mean on the robust cell (T=1,000),
   whose aggregator launches twice an iteration.
11. compression: the compression kernel (``ops/compression_kernels.py``,
   the estimate update memory + Q(v − memory) of one error-feedback
   exchange; no pallas_call behind it) against the plain twin of
   ``ops/compression.py`` in both dtypes at N=256, d=81 (the main path),
   N=25, d=81, N=4096, d=1024, N=64, d=5,000 and N=8, d=100,003 (rows past
   4,096, whose keys each radix pass recomputes), for top_k (k = 1, 9, 27, d), random_k (k
   = 9, 27) and qsgd (1, 4, 16 bits), seeds 0, 203, 2³¹ − 1 (and 2⁴⁰ + 5 in
   float64), t = 0, 12,345, 2³¹ − 1 and 2³² + 5, rounds 0 and 1, on inputs
   with ties at the k boundary, zero rows and −0.0: top_k and random_k
   bitwise, qsgd with no rounding decision differing and within 4 ulp of
   ω‖v‖/s; known-answer digests of the JAX package's random_k masks and
   qsgd uniforms (``COMPRESSION_KNOWN_ANSWERS``, one of them at d=5,000);
   the kernel's times at the main shape beside its twin, its bound and
   ``torch.topk`` of its scores, and at the wide shapes in both dtypes;
   the ``COMPRESSION_RUNS`` on the main path's data (N=256 ring, float32,
   eval every iteration, T=3,000), pallas and stencil, each within 1% of
   the JAX package's iterations to ε with its floats transmitted exactly,
   ``compress_exchange`` and (pallas) ``ring_mix`` launched T times (2T in
   GT) and ``fused_ring_dsgd_step`` never, the pallas runs bitwise their
   ``measure_timestamps=True`` runs and constant-step compressed D-SGD
   bitwise CHOCO; the uncompressed D-SGD and GT iters/s of the same call
   beside; and float64 runs on the card against the CPU (N=8, T=200,
   pallas on the ring and the fully-connected graph) to 1e-12 on the
   histories, the final models and the estimates.
12. topologies: D-SGD on Erdős–Rényi at N=256 with mean degree 12
   (``IRREGULAR_RUNS``, main-path data, float32, eval every 10, T=10,000)
   under mixing ``auto`` (the dense product), ``gather`` and ``sparse``:
   each within 1% of the JAX package's iterations to ε, the dense sampling
   kernel T times and no other launch, bitwise its
   ``measure_timestamps=True`` run; the three in float64 (T=200) on the
   card against the CPU to 1e-12; chain and star at N=25 in float64, card
   against CPU to 1e-12 and f(x̄_T) against the JAX package's
   (``STUDY_GRAPHS``) to 1e-12; ER at N=1024 (``ER_1024``, the whole shard
   each step) under the three forms, with iters/s. TF32 must be off.
13. push_sum: push-sum on the directed ER of the same p (T=10,000, ``auto``
   = dense): within 1% of the JAX count, bitwise its measured run, Σ w
   within 1e-5 N of the JAX package's and within the float32 weights'
   drift bound; the directed ring at N=25 in float64 under stencil, dense
   and sparse, each card run against the CPU and the three against each
   other to 1e-12; push-sum on the N=256 ring (T=3,000) with ``pallas``
   (``ring_mix`` 2T times, for num and w, no fused step) bitwise its
   stencil run, w exactly 1 in both.
14. study: the eight rows of ``examples/reproduce_report.py`` (the
   reference study's Tables I and II) with that script's config defaults:
   N=25, T=10,000, b=16, η₀=0.05/√(t+1), λ=1e-4, sorted partition,
   ε=0.08, float32; centralized SGD and D-SGD on the ring, the periodic
   5 × 5 grid and the fully-connected graph, for logistic and quadratic.
   Every row crosses ε within T and within 1% of the JAX package's count for
   the same row (``STUDY_ROWS``, jax 0.9.0; both draw the same batches);
   floats transmitted are exactly 4.05e7 (centralized, ring), 8.1e7 (grid)
   and 4.86e8 (fully connected); each run leaves the card's allocated memory
   as it found it. The published count is printed beside.
15. byzantine: the JAX package's breakdown demonstration
   (``examples/bench_byzantine.py``: N=64 ring, full batch, T=4,000,
   float32, fused screens) with its gates, each final honest gap within 1%
   of ``docs/perf/byzantine.json``; and its two large-noise rows (σ = 10,
   plain and the fused trimmed mean; ``large_noise`` launched T times),
   each within 1% of the JAX package's CPU value (``NOISE_REFERENCE``),
   the trimmed row within 1% of ``byzantine.json`` too (its plain row there
   is a TPU number, printed beside).
16. robust: the N=256 ring of ``examples/bench_fused_robust.py`` (d=41,
   b=16, T=5,000, sign-flip by 12 workers): plain gossip must diverge or
   end 10× above attack-free, every screen within 2× of attack-free; the
   fused robust step launches exactly T times in each fused run and never
   in the gather run, whose trimmed-mean history must agree with the fused
   one to 1e-6 relative. Then sign-flip on ER at N=64, p=0.1 (main-path
   data, T=2,000, rows of 3 to 13 neighbours): trimmed mean and median,
   fused (T launches, bitwise their measured runs) and gather (none), each
   pair within 1e-6 relative, the fused pair in float64 (T=200) against the
   CPU to 1e-12; and ``docs/perf/robust_scale.json``'s crossover cell (ER
   at p=0.5, k_max 40), which ``auto`` runs in the gather form. Then the
   ring cell under 10% edge drops, trimmed mean and median, fused (the
   kernel on a liveness gathered from each round's A_t, T launches) and
   gather, each pair within 1e-6 relative, ``realize_round`` T times, and
   gradient tracking's trimmed mean there (T=1,000; the aggregator kernel
   2T times) against its gather form; and
   the dense screen on the fully-connected graph (N=25 study data,
   sign-flip by 2, trimmed mean b=2, ``auto``): resolved to dense, finite
   over T=2,000, float64 card against CPU to 1e-12.
17. robust_mixing: the fused aggregator through the Byzantine mix on the
    robust run's final models, for each rule, against the gather form and
    the numpy oracle; and the pallas ``MixingOp`` on the fully-connected
    graph (``fc_mix``, ``fc_neighbor_sum``) against the dense W and A.
18. objectives: the Huber and softmax families, every line with the
    card's name and power limit. Huber at the main path's shapes
    (``HUBER_MAIN``: N=256 ring, regression data, L=49, the dense sampler):
    D-SGD under pallas and stencil in float64 (T=300) card against CPU to
    1e-12 (rtol and atol) and the final gap against the JAX package's
    (``JAX_FINAL_GAPS``) to 1e-12; in float32 at T=30,000, eval every 10,
    with iters/s, the launches exact and the pallas run bitwise its
    measured run; then ``tests/test_huber.py``'s gate on its small config
    (``HUBER_ORACLE``): GT and EXTRA pin the oracle (|gap| < 1e-9,
    consensus < 1e-12), D-SGD stalls above 1e-3. Softmax at K=10 on the
    study's N=25 ring (d_model = 810, L=500: the gather sampler copies the
    class labels): D-SGD (pallas), GT (``ring_mix`` at 810 columns, 2T) and
    CHOCO (81 of 810, the compression kernel's block-a-row path) in
    float64 card against CPU to 1e-12 with the floats transmitted exact
    (CHOCO's W x̂ is ``ring_mix``, T launches): top_k and random_k at γ =
    ``CHOCO_STABLE_GAMMA`` on every leaf, top_k at the study's γ = 0.3,
    which amplifies rounding, exchange by exchange (``_top_k_agree``),
    D-SGD's gap against the JAX package's, and D-SGD in float32 at
    T=10,000 bitwise its measured run. The ring kernels at [25, 810] and
    the fused step at [8, 2,097,664] and [8, 4,194,816], and the
    compression kernel at [25, 810], bitwise their plain versions, timed
    in a graph against the bytes bound. The compute-bound cells of
    ``examples/bench_compute_bound.py`` (``COMPUTE_BOUND``: N=8, K=512,
    b = L = 2,048, d = 4,096 and 8,192 features plus bias, its random
    data, f* = 0): float32 under ``matmul_precision`` 'highest' and
    'default', stencil and pallas, each finite and decreasing over T=200,
    then timed with metrics off (iters/s, TFLOP/s from 4·N·b·d·K, and its
    share of the FP32 or dense TF32 peak); at d = 4,096 three float32
    iterations against float64 on the CPU ('highest' within
    ``COMPUTE_BOUND_TOL``, 'default' farther off). TF32 must be off before
    and after every run.

19. faults: the three draw kernels (``ops/draw_kernels.py``: one round's
    mixing operands, the fault timeline, the large-noise payload; no
    pallas_call behind them) bitwise their plain versions on the card:
    realize_round's A_t, active, W_t (float32 and float64), degree count
    and one-peer scores, on the ring, Erdős–Rényi,
    grid, directed ring and directed ER at N=64, 256 and 1,024 and the
    fully-connected graph at N=25 (``ROUND_GRAPHS``), under every fault
    mode (``ROUND_MODES``: drops, stragglers, both, bursty edges, churn
    with either rejoin policy, participation, one-peer), a timeline's also
    at and past its horizon; the timeline (two launches: the draws, the
    scan) at the churn phase's processes over horizons across its segment
    and tile edges (``TIMELINE_HORIZONS``) and at ``TIMELINE_SHAPES`` (the
    churn GT cell, bursty N=64 at T=20,000, main's shape at T=30,000); the
    noise in both dtypes up to 4,096 × 1,024 and 8 × 4,194,816
    (``NOISE_CHECK_SHAPES``), honest rows equal to x; each timed against
    its bound in a graph and event-timed (realize_round at main's faulted
    shape, the timeline at ``TIMELINE_SHAPES``, the noise at
    ``NOISE_TIMED``);
    ``examples/bench_faults.py``'s twelve variants (logistic N=64 ring, the
    gather sampler, T=20,000, eval every iteration: D-SGD fault-free, 20%
    drops, 10% stragglers, both, one-peer, round-robin; GT and push-sum on
    the directed ring fault-free, drops, stragglers), each within 1% of the
    JAX package's iterations to ε (``FAULT_ROWS``) with its floats
    transmitted exactly the JAX package's (fault-free the analytic
    2|E|·payload·T, round-robin exactly half), ``realize_round`` T times
    in each memoryless faulted run; main's shapes under 20% drops and 10%
    stragglers (the fused ring step off), bitwise its measured run at
    T=3,000; main's shapes under bursty drops and churn
    (``FULL_WIDTH_FAULTS``, T=30,000), its timeline bitwise the plain
    version's on the CPU and its graph run bitwise its measured run at
    T=1,000, with its set-up seconds (timeline included); the robust cell
    (N=256 ring, d=41) under ``large_noise`` at scale 10, trimmed mean b=1,
    fused and gather, ``large_noise`` T times; each fault mode in float64
    on the card against the CPU (1e-12).
20. churn: ``examples/bench_churn.py``'s four gates (quadratic N=16 ring):
    ``burst_len=1`` bitwise the iid run, B̂ growing with the burst length
    (timelines drawn by the kernel), GT's tracking residual under churn
    below 1e-9 in float64, ``neighbor_restart`` ending at or below
    ``frozen``'s consensus after 150-round outages; ``fault_timeline``'s
    two launches once in each run with bursty edges or churn, and
    ``realize_round`` once
    a step in every run (it reads the timeline where there is one).
21. replicas: the replica axis (``torch_backend.run_batch``). The four
    kernels that take it (both samplers, the round, the noise; float32 at
    each one's path shape): one launch bitwise its plain stack, and
    replica r of it bitwise single launch r, at R = 1, 3, 8 and 32 (the
    records' max_abs_err is the launch's against the plain stack); in a
    graph of 200, one launch for R against
    R single launches, beside the bound, at R = 1, 8 and 32 (their
    records carry R = 32). ``examples/bench_sweep.py``'s two cells
    (flagship N=25, T=2,000, eval every 500, R = 1 … 32; northstar
    N=256, T=400, eval every 100, R = 8 and 32) beside the single run
    in the same call, and its η₀ sweep of 8 values. Main's config at R =
    8 (seeds 203–210, T=30,000, eval every iteration): every replica
    crosses ε, replica 0 within 1% of the main phase's count, the
    sampler launched T times; at T=1,000 the graph run bitwise its
    measured run; float64 at R = 3 (T=100) within 1e-12 of the CPU's
    batch. Main's shapes under bursty drops, churn, sign-flip and the
    gather trimmed mean at R = 4 (T=3,000): the round T times, the
    timeline twice a replica, each replica's floats equal to its
    sequential run's and its gaps within 1e-4 relative of them (float32,
    two product orders); the robust cell under large_noise at R = 4: the
    noise T times.
22. federated: the JAX package's federated-scale cells on one card
    (quadratic, 16 features, float32; ``FEDERATED_BASE``), each with its
    graph and timeline set-up seconds, graph iters/s, peak device memory,
    gaps and resolved representation and sampler: (i)
    ``examples/bench_federated.py``'s ER scale cells (p = 12/N, n_samples =
    2N, b = 4, T = 100, an eval at 100), 'neighbor' at N = 1,024, 4,096
    and 10,000 and 'dense' below 10,000, timed over 1,000 iterations (the
    T = 100 run bitwise the timed run's first eval at N = 1,024), the
    N = 1,024 pair in float64 within 1e-12; (ii) ``bench_worker_mesh.py``'s
    er_100k_p4_sparse unsharded (N = 100,000, p = 16/N, topology_seed 1,
    T = 50, eval every 25; 'auto' takes the matrix-free graph and the
    sparse sampler): the table's digest the JAX package's
    (``ER_100K_DIGEST``), fault-free floats 2|E|·d·T, under 10% iid drops
    and participation 0.5 the floats the live slots of the run's own
    timeline × d, ``realize_slot_round`` twice a step (iters/s beside the
    parent's, ``FEDERATED_PARENT``) and
    ``fault_timeline`` twice a run, and in float64 at T = 10 the card
    within 1e-12 of the CPU; (iii) ``bench_mesh_scale.py``'s ring_1m_p16
    unsharded (ring N = 1,000,000, neighbor, gather, b = 1, timed over 100
    iterations with an eval every 10, whose first eval the cell's own T = 10
    run equals bit for bit).
23. async: the asynchronous event clock (``execution='async'``,
    ``backends/async_scan.py``): a block of events' batches one launch of
    the event sampler (the gather kernel's event mode, a grid block a
    draw), the events replayed as CUDA graphs over a device cursor; each
    cell's events/s printed beside the parent's (``ASYNC_PARENT``). ``examples/bench_async.py``'s four latency
    cells (quadratic N=32 ring, T=2,000, b=16, eval every 50, float32;
    ``ASYNC_BENCH``) beside the port's sync one-peer and full-gossip runs:
    each final gap within 1% of the JAX package's (``ASYNC_REFERENCE``),
    floats exact, the sampler once a block of events, the bench's wall-clock speedup
    floors (2, 3, 3) and final-gap envelopes (1.25, 1.3, 2), and at
    constant latency the synchronous clock, zero skew and one-peer's
    floats; its degenerate gate (N=16, T=200, float64, shared batches):
    async against sync one-peer and card against CPU, each within 1e-12;
    ``examples/bench_async_faults.py``'s cells (N=16, T=800, lognormal
    1.25, seed 7): churn 12/4 and participation 0.75 each at least 0.8×
    healthy and within 2× of each other, the floats the fired live
    exchanges, the wall-clock speedup under churn at least 2, and GT under
    churn with participation 0.9 in float64 with |mean y − mean g_prev| below
    1e-9; main's shapes on the event clock (N=256 ring, logistic, L=49, b=16,
    lognormal 1.25, T=200: 51,200 events; events/s, µs an event, capture
    seconds, gap digest) and a T=20 run's graph bitwise its uncaptured run;
    the block sampler at main's shard (blocks of 256 events at the run's
    first, one inside and the schedule's last, 200 at τ = 2) bitwise its
    plain version and its events' own launches, timed in a graph and
    event-timed beside 256 launches of the per-event entry (its record in
    the ``kernels`` line).
24. bfloat16: ``dtype='bfloat16'``, rounded op by op as the JAX package
    rounds it (``ops/rounding.py``). Every bfloat16 kernel instance
    against its twin on the card: the ring kernels bitwise at main's shape
    and the compute-bound widths [8, 2,097,664] and [8, 4,194,816]; the fc
    kernels bitwise the mirror of their order and within a bfloat16 ulp of
    the twin (the elements that differ counted) at N=25, 256 and 4,096;
    both samplers bitwise (indices, weights, rows and int32 labels, the
    weights the float32 draw's cast) at the sampling phase's inputs; each
    timed in a graph and event-timed beside its plain version, the library
    call in bfloat16 and the bound of 2-byte elements (records named
    ``<kernel>, bfloat16``). Main's config (N=256 ring, logistic, b=16,
    T=30,000) in bfloat16 and float32, pallas and stencil: iters/s, the
    final gap and the iteration at ε=0.08 where crossed; the card against
    the port's CPU run of it at T=100 (dense sampling on both), the gap
    within ``BF16_GAP_ULPS`` bfloat16 ulps of f(x̄); main's shapes under 20%
    drops and 10% stragglers (T=1,000): the floats sent equal the float32
    run's exactly; short runs (T=500) that launch ring_mix (GT, parity
    ring), ring_neighbor_sum (ADMM, main's ring), fc_mix and
    fc_neighbor_sum (D-SGD and ADMM, fully connected N=25) and the gather
    sampler, each counted exactly; and ``bench_compute_bound.py``'s
    d4096_bf16 and d8192_bf16 cells (softmax K=512, N=8, b=2048, stencil
    and pallas): the 512 labels exact (int32), finite and decreasing over
    T=200, TFLOP/s = 4·N·b·d·K × iters/s against the dense bfloat16 peak of
    989 TFLOP/s. The robust and compression kernels' bfloat16 instances:
    the robust kernels at the kernels phase's four inputs, every screen,
    aggregator and step (count rules bitwise the twin, clipping within a
    bfloat16 ulp and its step bf16(agg) − bf16(η·g) of its own aggregate),
    timed at the ring and the ER N=64 table beside the float32 instance;
    the compression kernel bitwise its twin at every shape and operator of
    the compression phase, timed at main's shape beside float32. Then the
    robust cell's fused trimmed mean under 10% edge drops (D-SGD T=1,000,
    and GT T=500 for the aggregator) and choco_randk27 (T=1,000) in
    bfloat16 beside float32, launches counted exactly, and the card
    against the port's CPU run of each at T=100, the gap within
    ``BF16_GAP_ULPS`` bfloat16 ulps.

Every run goes through the port's run loop: after a warm-up chunk, CUDA
graph replays (``backends/torch_backend.py``). The kernels count their own
launches on the card, replays included (``csrc/launch_counts.cuh``). Each
phase that drives a path sets the launch counts to 0 just before it and
reads them just after; converging and screened runs print a sha256 digest of their gap
history, so two trees run in one call can be shown to give bitwise-equal
histories. On request, ``profile`` traces 300 iterations of the main path,
of the admm phase's ring, of gradient tracking on the main path's data and
of the robust cell's fused trimmed-mean run (that run also under 10% edge
drops) with ``torch.profiler`` (and main's shapes under 20% drops and 10%
stragglers, three of ``FAULT_ROWS``' N=64 cells, CHOCO with random_k and
compressed GT with qsgd on the main path's data, D-SGD on the topologies phase's ER graph
under dense, gather and sparse, push-sum on its directed ER, Huber at
N=256, softmax K=10 at N=25, main's config in bfloat16 (pallas and
stencil), and the compute-bound cell at d=4,096 under both precisions and
in bfloat16, 40 iterations at eval every 10, and the federated phase's
cells, ``_profile_federated``), each as the
graph run and as the ``measure_timestamps=True`` run, over the iterations
after the warm-up chunk; ``ab`` (``--phases card,ab --ab-baseline DIR``,
DIR the root of another checkout, such as an unpacked ``git archive`` of
the parent) imports that tree's kernel wrappers beside this tree's and
runs each kernel of the ``kernels`` line through both on the same input at
its path's shape in float32 (``ab_calls``): the outputs bitwise equal, then
a launch in a graph of 200 in turns baseline, this tree, this tree,
baseline; a kernel whose baseline wrapper refuses the call is named and
skipped. A redesign with another interface gets a row both trees take:
``sample_event_block`` holds a block of 256 events against 256 launches of
a tree's per-event ``sample_event_batch`` where it has no block entry, and
``realize_slot_round`` runs at the federated cell's table and the ring. ``profile`` also traces the parity run (N=25, gather sampling).

The line before the last is the JSON ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
and prints no result line. Without a card it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

PHASES = ("card", "kernels", "sampling", "reference", "parity", "main", "mixing", "fc", "admm",
          "tracking", "compression", "topologies", "push_sum", "study", "byzantine", "robust",
          "robust_mixing", "objectives", "faults", "churn", "replicas", "federated", "async",
          "bfloat16")
# Run only when asked for: profile, a torch.profiler trace of the main
# path's, the admm ring's, the robust cell's and the federated cells' steady
# loops, graph and measured; ab (with --ab-baseline), every kernel's wrapper
# against another tree's on the same input, bitwise and in a graph in turns.
OPTIONAL_PHASES = ("profile", "ab")

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

MAIN_SHAPE = (256, 81)
ROBUST_SHAPE = (256, 41)  # the robust cell: its benign ring mix, its fc check
# The main path's T: past the ε=0.08 crossing near 22,500 iterations that the
# JAX package recorded, cut from bench.py's 300,000 so that the whole script
# stays well under 600 s.
MAIN_ITERATIONS = 30_000
# The JAX package's d-sweep of the ring at N=256 (examples/
# bench_pallas_regimes.py:86), its widths from 128 to 1024 in powers of two.
D_SWEEP = tuple((256, d) for d in (128, 256, 512, 1024))
# The million-worker ring of the JAX package's scale study
# (docs/perf/mesh_scale.json, cell ring_1m_p16): 17 floats a row.
MILLION_RING = (1_000_000, 17)
SHAPES = (MAIN_SHAPE, ROBUST_SHAPE, *D_SWEEP, (4096, 1024), MILLION_RING)
# The ring kernels' library yardstick multiplies by the dense [N, N] W or A
# up to this size, and by the CSR ring matrix (cuSPARSE) beyond it.
DENSE_LIBRARY_BYTES = 1 << 30
# The admm phase's T: past the ε=0.08 crossings the JAX package shows (214
# on the N=256 ring, 165 on the N=25 fully-connected graph) by a wide margin.
ADMM_ITERATIONS = 2_000
# The JAX package's float32 figures at the admm phase's configurations, on
# a CPU with use_mesh=False (the same batches as the port's since the port
# draws from the twin of jax.random; printed beside, not gated on);
# tests/test_torch_admm.py recomputes them.
ADMM_REFERENCE = {"ring": {"iters_to_eps": 214, "final_gap": 2.123e-3, "consensus": 0.09364},
                  "fully_connected": {"iters_to_eps": 165, "final_gap": 9.795e-4,
                                      "consensus": 3.084e-3}}
# The fc kernels' shapes: the fc path, robust_mixing's, and two widths of
# 1024 whose x and out (33.5 MB and 134 MB in float32) stay within and go
# beyond the 50 MB L2 between timed launches.
FC_SHAPES = ((25, 81), ROBUST_SHAPE, (256, 81), (4096, 1024), (16384, 1024))
# The dense W x yardstick is printed up to this N.
FC_DENSE_MAX_N = 4096
# The shape of both fc kernels' paths: the fc phase, and admm's fc run.
FC_RECORD_SHAPE = (25, 81)
ROBUST_RECORD = ("ring", "trimmed_mean")  # the robust phase's path
TIMED_LAUNCHES = 200
PALLAS = "distributed_optimization_tpu/ops/pallas_kernels.py"
CSRC = "distributed_optimization_tpu_torch/csrc"
SOURCES = {
    "fused_ring_dsgd_step": "ring_kernels.cu", "ring_mix": "ring_kernels.cu",
    "ring_neighbor_sum": "ring_kernels.cu", "fc_mix": "fc_kernels.cu",
    "fc_neighbor_sum": "fc_kernels.cu", "make_fused_robust_aggregator": "robust_kernels.cu",
    "make_fused_robust_dsgd_step": "robust_kernels.cu",
    "sample_worker_batch_weights": "sampling_kernels.cu",
    "sample_worker_batches": "sampling_kernels.cu",
    "compress_exchange": "compression_kernels.cu",
    "realize_round": "draw_kernels.cu", "fault_timeline": "draw_kernels.cu",
    "large_noise": "draw_kernels.cu",
    "sample_worker_batch_weights, replica axis": "sampling_kernels.cu",
    "sample_worker_batches, replica axis": "sampling_kernels.cu",
    "realize_round, replica axis": "draw_kernels.cu",
    "large_noise, replica axis": "draw_kernels.cu",
    "realize_slot_round": "draw_kernels.cu",
    "fault_timeline, per-edge stream": "draw_kernels.cu",
    "sample_event_block": "sampling_kernels.cu",
}
REPLACES = {
    "fused_ring_dsgd_step": f"{PALLAS}:143", "ring_mix": f"{PALLAS}:137",
    "ring_neighbor_sum": f"{PALLAS}:177", "fc_mix": f"{PALLAS}:172",
    "fc_neighbor_sum": f"{PALLAS}:183", "make_fused_robust_aggregator": f"{PALLAS}:410",
    "make_fused_robust_dsgd_step": f"{PALLAS}:430",
    # No pallas_call stands behind the sampling kernels: they take the place
    # of the XLA code of the JAX package's sampler.
    "sample_worker_batch_weights": "distributed_optimization_tpu/ops/sampling.py:79",
    "sample_worker_batches": "distributed_optimization_tpu/ops/sampling.py:122",
    # No pallas_call stands behind the compression kernel either: it takes the
    # place of the XLA code of the error-feedback exchange's estimate update.
    "compress_exchange": "distributed_optimization_tpu/ops/compression.py:176",
    # No pallas_call stands behind the draw kernels: they take the place of
    # the XLA code of jax.random in the fault layer and the large-noise attack.
    "realize_round": "distributed_optimization_tpu/parallel/faults.py:223",
    "fault_timeline": "distributed_optimization_tpu/parallel/faults.py:419",
    "large_noise": "distributed_optimization_tpu/parallel/adversary.py:126",
    # The matrix-free fault form: _make_gather_faulty_mixing's round (live,
    # weights, degree sum) and build_fault_timeline's per-edge draws.
    "realize_slot_round": "distributed_optimization_tpu/parallel/faults.py:1133",
    "fault_timeline, per-edge stream": "distributed_optimization_tpu/parallel/faults.py:489",
    # The event clock's per-event batch draw (no Pallas kernel), a launch a
    # block of events.
    "sample_event_block": "distributed_optimization_tpu/backends/async_scan.py:516",
}
# The replica axis (run_batch): the same four kernels, one launch for R
# replicas (the replicas phase).
REPLICA_KERNELS = ("sample_worker_batch_weights", "sample_worker_batches", "realize_round",
                   "large_noise")
REPLACES.update({f"{name}, replica axis": REPLACES[name] for name in REPLICA_KERNELS})
# The bfloat16 instances (the bfloat16 phase) of the ring, fc and sampling
# kernels: the same sources, entry points suffixed _bf16.
BF16_KERNELS = ("fused_ring_dsgd_step", "ring_mix", "ring_neighbor_sum", "fc_mix",
                "fc_neighbor_sum", "sample_worker_batch_weights", "sample_worker_batches",
                "make_fused_robust_aggregator", "make_fused_robust_dsgd_step",
                "compress_exchange")
REPLACES.update({f"{name}, bfloat16": REPLACES[name] for name in BF16_KERNELS})
SOURCES.update({f"{name}, bfloat16": SOURCES[name] for name in BF16_KERNELS})
# Floating-point operations per element of the [N, d] output.
OPS_PER_ELEMENT = {"fused_ring_dsgd_step": 4, "ring_mix": 3, "ring_neighbor_sum": 1,
                   "fc_mix": 2, "fc_neighbor_sum": 2}
# (rule, clip_tau) of the robust kernels' screens.
SCREENS = (("trimmed_mean", 0.0), ("median", 0.0), ("clipped_gossip", 0.0),
           ("clipped_gossip", 0.5))

# The study phase's rows (examples/reproduce_report.py): (problem, label)
# -> (algorithm, topology, published iterations to ε (BASELINE.md), the JAX
# package's at the same config (jax 0.9.0 on a CPU, use_mesh=False; the port
# draws its batches; tests/test_torch_study.py recomputes them), floats
# transmitted).
STUDY_ROWS = {
    ("logistic", "Centralized SGD"): ("centralized", "ring", 9_641, 9_592, 4.05e7),
    ("logistic", "D-SGD (ring)"): ("dsgd", "ring", 9_927, 9_910, 4.05e7),
    ("logistic", "D-SGD (grid)"): ("dsgd", "grid", 9_636, 9_622, 8.1e7),
    ("logistic", "D-SGD (fully connected)"): ("dsgd", "fully_connected", 9_596, 9_608, 4.86e8),
    ("quadratic", "Centralized SGD"): ("centralized", "ring", 5_425, 5_394, 4.05e7),
    ("quadratic", "D-SGD (ring)"): ("dsgd", "ring", 7_214, 7_136, 4.05e7),
    ("quadratic", "D-SGD (grid)"): ("dsgd", "grid", 5_666, 5_558, 8.1e7),
    ("quadratic", "D-SGD (fully connected)"): ("dsgd", "fully_connected", 5_549, 5_525, 4.86e8),
}
# The study's and the tracking phase's gate: each count within 1% of the JAX
# package's.
COUNT_TOLERANCE = 0.01

# The JAX package's float32 final honest gaps at the byzantine phase's
# configuration (docs/perf/byzantine.json, written by
# examples/bench_byzantine.py on a CPU); signflip_plain diverges there.
BYZANTINE_REFERENCE = {"attack_free": 0.042538, "signflip_tm": 0.044533,
                       "signflip_median": 0.044533, "signflip_clip": 0.045254,
                       "alie_tm": 0.04402}
# The JAX package's float32 final honest gaps at the robust phase's
# configuration, on a CPU with use_mesh=False (the same batches as the
# port's; printed beside, not gated on).
ROBUST_REFERENCE = {"attack_free": 0.03952, "signflip_plain": float("nan"),
                    "signflip_trimmed_mean": 0.04787, "signflip_median": 0.04787,
                    "signflip_clipped_gossip": 0.05409}


# The JAX package's float32 final honest gaps of bench_byzantine.py's two
# large-noise rows on a CPU (jax 0.9.0, use_mesh=False; the same draws as the
# port's; tests/test_torch_large_noise.py recomputes them), gated within 1%,
# and docs/perf/byzantine.json's, printed beside: noise_tm's agrees, while
# noise_plain's (4.884777) was taken on a TPU, whose default float32 products
# round differently, and this unscreened row carries that difference.
NOISE_REFERENCE = {"noise_plain": 9.819153785705566, "noise_tm": 0.04345285892486572}
NOISE_JSON = {"noise_plain": 4.884777, "noise_tm": 0.043449}

# examples/bench_faults.py's configuration (logistic, N=64 ring, n=12,500,
# d=81: L=196, the gather sampler; T=20,000, b=16, float32, eval every
# iteration) and its twelve variants: name -> (fields, the JAX package's
# iterations to ε, final gap and floats transmitted; jax 0.9.0 on a CPU,
# use_mesh=False; tests/test_torch_fault_screens.py recomputes one row).
FAULTS_BASE = dict(problem_type="logistic", algorithm="dsgd", topology="ring", n_workers=64,
                   n_iterations=20_000)
_GT = dict(algorithm="gradient_tracking")
_PS = dict(algorithm="push_sum", topology="directed_ring")
FAULT_ROWS = {
    "fault_free": ({}, 11151, 0.059920161962509155, 207360000.0),
    "edge_drop_20pct": (dict(edge_drop_prob=0.2), 11438, 0.06063699722290039, 165943242.0),
    "stragglers_10pct": (dict(straggler_prob=0.1), 13760, 0.06681433320045471, 168016680.0),
    "edge20_straggler10": (dict(edge_drop_prob=0.2, straggler_prob=0.1), 14082,
                           0.06751731038093567, 134428572.0),
    "one_peer_gossip": (dict(gossip_schedule="one_peer"), 13036, 0.06444782018661499,
                        51909174.0),
    "round_robin_matchings": (dict(gossip_schedule="round_robin"), 10717, 0.05890282988548279,
                              103680000.0),
    "gt_fault_free": (_GT, 341, 6.93202018737793e-05, 414720000.0),
    "gt_edge_drop_20pct": (dict(_GT, edge_drop_prob=0.2), 363, 0.005829840898513794,
                           331886484.0),
    "gt_stragglers_10pct": (dict(_GT, straggler_prob=0.1), 393, 0.000991731882095337,
                            336033360.0),
    "ps_fault_free": (_PS, 9609, 0.05628576874732971, 104960000.0),
    "ps_edge_drop_20pct": (dict(_PS, edge_drop_prob=0.2), 9635, 0.05635389685630798,
                           83962834.0),
    "ps_stragglers_10pct": (dict(_PS, straggler_prob=0.1), 11866, 0.06266701221466064,
                            85045480.0),
}
# Main's shapes (N=256 ring, L=49, the dense sampler, T=30,000) under faults.
FAULT_MAIN = dict(edge_drop_prob=0.2, straggler_prob=0.1)
FAULT_MAIN_MEASURED = 3_000  # the graph-vs-measured check's T
# Each fault mode in float64 on the card against the CPU (N=64, T=100).
FAULT_F64 = {
    "edges": dict(edge_drop_prob=0.2), "stragglers": dict(straggler_prob=0.1),
    "both": dict(edge_drop_prob=0.2, straggler_prob=0.1),
    "one_peer": dict(gossip_schedule="one_peer", edge_drop_prob=0.1),
    "round_robin": dict(gossip_schedule="round_robin"),
    "bursty": dict(edge_drop_prob=0.3, burst_len=4.0),
    "churn_restart": dict(mttf=20.0, mttr=5.0, rejoin="neighbor_restart"),
    "participation": dict(participation_rate=0.8, edge_drop_prob=0.1),
    "gt_both": dict(_GT, edge_drop_prob=0.2, straggler_prob=0.1),
    "ps_both": dict(_PS, edge_drop_prob=0.2, straggler_prob=0.1),
}
FAULT_F64_ITERATIONS = 100
# examples/bench_churn.py's configuration and its burst sweep.
CHURN_BASE = dict(problem_type="quadratic", algorithm="dsgd", topology="ring", n_workers=16,
                  n_samples=1600, n_features=10, n_informative_features=6, n_iterations=3000,
                  local_batch_size=16, eval_every=100)
CHURN_P = 0.3
CHURN_BURSTS = (1.0, 4.0, 16.0, 48.0)
CHURN_GT = dict(algorithm="gradient_tracking", lr_schedule="constant", learning_rate_eta0=0.02,
                dtype="float64", n_iterations=1000, edge_drop_prob=0.2, burst_len=8.0,
                mttf=60.0, mttr=25.0)
CHURN_OUTAGE = dict(n_iterations=2000, mttf=400.0, mttr=150.0)
# The draw kernels' record inputs: realize_round at main's faulted shape,
# fault_timeline at the churn phase's GT cell, large_noise at the byzantine
# phase's noise rows (N=64, d=11).
NOISE_SHAPE = (64, 11)
# bench_churn.py's GT processes: bursty edge drops and churn.
_BURSTY_CHURN = dict(edge_drop_prob=0.2, burst_len=8.0, mttf=60.0, mttr=25.0)
# The timeline's timed shapes, (label, ring N, T, processes): the churn GT
# cell, FAULT_F64's bursty mode at FAULTS_BASE's horizon, main's shape under
# bursty drops and churn.
TIMELINE_SHAPES = (("churn_gt", 16, CHURN_GT["n_iterations"], _BURSTY_CHURN),
                   ("bursty_n64", 64, FAULTS_BASE["n_iterations"], FAULT_F64["bursty"]),
                   ("main", 256, MAIN_ITERATIONS, _BURSTY_CHURN))
# Horizons across the timeline kernels' segment (16 rounds) and tile (128)
# edges.
TIMELINE_HORIZONS = (1, 2, 15, 16, 17, 31, 32, 33, 127, 128, 129, 1000)
# The noise kernel's shapes held bitwise its plain version, and its timed
# ones: the path's, main's, every tenth row of 4,096 × 1,024, one row of the
# compute-bound tier's width (d = 8,193 × K = 512).
NOISE_CHECK_SHAPES = (NOISE_SHAPE, (256, 81), (25, 810), (4096, 1024), (8, 4_194_816))
NOISE_TIMED = (NOISE_SHAPE, (256, 81), (4096, 1024), (8, 4_194_816))
# Main's shapes (N=256 ring, L=49, the dense sampler, T=30,000) under bursty
# drops and churn, frozen rejoin: the timeline's full-width path.
FULL_WIDTH_FAULTS = dict(_BURSTY_CHURN, rejoin="frozen")
FULL_WIDTH_MEASURED = 1_000  # its graph-vs-measured check's T
# The round kernel's graphs, held bitwise to its plain version in every fault
# mode (ROUND_MODES), W_t in both dtypes: (name, N), Erdős–Rényi
# and directed ER at mean degree 12 (p = 12 / N).
ROUND_GRAPHS = tuple((g, n) for g in ("ring", "erdos_renyi", "grid", "directed_ring",
                                      "directed_erdos_renyi") for n in (64, 256, 1024))
ROUND_GRAPHS += (("fully_connected", 25),)
ROUND_DEGREE = 12.0
# The fault modes, make_faulty_mixing's arguments: memoryless draws, the
# timeline's processes (horizon 60), one-peer scores.
ROUND_HORIZON = 60
ROUND_MODES = {
    "drops": dict(drop_prob=0.2),
    "stragglers": dict(drop_prob=0.0, straggler_prob=0.1),
    "both": dict(drop_prob=0.2, straggler_prob=0.1),
    "bursty": dict(drop_prob=0.3, burst_len=4.0, horizon=ROUND_HORIZON),
    "churn_frozen": dict(drop_prob=0.2, mttf=8.0, mttr=3.0, horizon=ROUND_HORIZON),
    "churn_restart": dict(drop_prob=0.0, mttf=8.0, mttr=3.0, rejoin="neighbor_restart",
                          horizon=ROUND_HORIZON),
    "participation": dict(drop_prob=0.1, participation_rate=0.7, horizon=ROUND_HORIZON),
    "one_peer": dict(drop_prob=0.2, straggler_prob=0.1, one_peer=True),
}
# Floating-point operations of one normal draw's erf_inv (log1p, the Horner
# steps, the select and the products), by dtype.
ERF_INV_OPS = {"float32": 2 * 9 + 24, "float64": 2 * 23 + 30}

# The sampling kernel's inputs (label, N, L, b): the main path's dense form,
# the parity path's gather form, the robust cell. Every input also has three
# ragged shards (sampling_n_valid). Held at each seed, slot and counter here.
SAMPLING_SHAPES = (("main", 256, 49, 16), ("parity", 25, 500, 16), ("robust", 256, 50, 16))
SAMPLING_SEEDS = {"float32": (0, 42, 2**31 - 1), "float64": (0, 42, 2**31 - 1, 2**40 + 5)}
SAMPLING_COUNTERS = (0, 2**31 - 1)
SAMPLING_SLOTS = (0, 1, 2)  # slots 0 … τ−1 at the tracking phase's τ = 3
# Each sampling kernel's record: its path's input, float32.
SAMPLING_RECORD = {"sample_worker_batch_weights": ("main", 256, 49, 16),
                   "sample_worker_batches": ("parity", 25, 500, 16)}
SAMPLING_PATHS = {"sample_worker_batch_weights": "main: dsgd, ring, N=256, dense, once a grad call",
                  "sample_worker_batches": "parity: dsgd, ring, N=25, gather, once a grad call"}
# The width of a shard's rows on the parity and main paths (80 features and
# the bias): the gather form's X [N, L, d].
SAMPLING_D = 81
# The gather form's plan past a block's 1,024 threads, (N, L) at b = 16:
# one block with 8 rows a thread (the launcher's plan up to 8,192 rows)
# against a thread block cluster of a thread a row, timed in turns.
SAMPLING_PLAN_SHAPES = ((4, 1100), (25, 1100), (4, 7000), (25, 7000))
# A shard past the 65,536 rows a cluster holds in registers, where each
# thread recomputes its rows' keys at every radix pass: (N, L, b), N=1 as a
# single worker holding more than 65,536 samples; held bitwise to the twin
# at N=1 and with the ragged shards of sampling_n_valid at N=4, timed at N=1.
SAMPLING_LONG = (1, 100_000, 16)
# Known answers: sha256 (first 16 hex digits) of the JAX package's draws with
# jax 0.9.0 at (seed, slot, t, dtype, N, L, b), n_valid as sampling_n_valid
# gives it: the masked uniform scores [N, L] (ops/sampling.py's
# _masked_scores, under enable_x64 in float64), the dense weights [N, L]
# (float32) and the gather indices [N, b] (as int64). tests/test_torch_prng.py
# recomputes them from the JAX package.
KNOWN_ANSWERS = {
    (203, 0, 0, "float32", 256, 49, 16): ("993c2b5c74102144", "50b173b6f96bda24",
                                          "7de8b2b05155ac3d"),
    (42, 1, 2**31 - 1, "float32", 25, 500, 16): ("f88cb8e435d31919", "b7cf4bff9e6b1a3f",
                                                 "1cc6e9bfb8773301"),
    (2**31 - 1, 2, 7, "float64", 256, 50, 16): ("1ef1439b3c0b533a", "2d5a0e7508f54d3b",
                                                "efbe01b2605df4ab"),
    (2**40 + 5, 0, 12_345, "float64", 25, 500, 16): ("ce15c5f081dfd885", "c3c0f374de42fc44",
                                                     "b77743bc96e70b73"),
}
# Integer operations a second: the data sheet's 67 TFLOP/s float32 counts an
# FMA as two operations on 128 lanes a multiprocessor; an SM has 64 INT32
# lanes (Hopper white paper), one operation each a clock.
PEAK_INT32_OPS = 67e12 * 64 / (128 * 2)
# Integer operations of one Threefry-2x32 call (key parity 2, first key
# injection 2, 20 rounds of add, rotate, xor, 5 injections of 3 adds).
THREEFRY_OPS = 2 + 2 + 20 * 3 + 5 * 3
# The tracking phase's runs on the main path's data (N=256 ring, logistic,
# float32, eval every iteration), with T, and the JAX package's iterations to
# ε=0.08 at each (jax 0.9.0 on a CPU, mixing 'stencil', use_mesh=False; both
# packages draw the same batches). tests/test_torch_tracking.py recomputes
# them.
TRACKING_RUNS = {
    "gradient_tracking": (dict(algorithm="gradient_tracking"), 3_000, 823),
    "extra": (dict(algorithm="extra"), 3_000, 291),
    "dsgd_tau3": (dict(algorithm="dsgd", local_steps=3), 10_000, 6_949),
}
# The tracking phase's screened run: GT on the robust cell's data under
# sign-flip with the fused trimmed mean, T iterations.
TRACKING_ROBUST_ITERATIONS = 1_000

# The compression kernel's inputs (N, d): the main path, the study's N=25,
# the stress width, and rows past 4,096 (the block path's keys held in
# registers up to 4,096 columns, recomputed at each radix pass past that);
# its operators (name, k; None is k = d) at each; the seeds, counters (past
# 2³¹ − 1 and past 2³² as well) and rounds of its draws. top_k draws
# nothing, so it is held once a shape and dtype.
COMPRESSION_SHAPES = ((256, 81), (25, 81), (4096, 1024), (64, 5_000), (8, 100_003))
COMPRESSION_OPERATORS = (("top_k", 1), ("top_k", 9), ("top_k", 27), ("top_k", None),
                         ("random_k", 9), ("random_k", 27), ("qsgd", 1), ("qsgd", 4),
                         ("qsgd", 16))
COMPRESSION_SEEDS = {"float32": (0, 203, 2**31 - 1), "float64": (0, 203, 2**31 - 1, 2**40 + 5)}
COMPRESSION_COUNTERS = (0, 12_345, 2**31 - 1, 2**32 + 5)
COMPRESSION_ROUNDS = (0, 1)
# The operators the compression runs launch, timed at the main shape in
# float32; the record is random_k k=27 (choco_randk27 and dsgd_randk27_const).
COMPRESSION_TIMED = (("top_k", 9), ("random_k", 27), ("qsgd", 4))
COMPRESSION_RECORD = ("random_k", 27)
# The wide shapes timed in both dtypes (no workload of the repo runs them).
COMPRESSION_WIDE_TIMED = ((4096, 1024), (64, 5_000), (8, 100_003))
# Known answers: sha256 (first 16 hex digits) of the JAX package's draws with
# jax 0.9.0 at (seed, t, round, dtype, N, d, k): random_k's mask [N, d]
# (int32, 1 where kept, of make_compressor('random_k', d, k).apply(key,
# ones)) and qsgd's uniforms jax.random.uniform(compression_key(seed, t,
# round), (N, d), dtype), under enable_x64 in float64.
# tests/test_torch_compression.py recomputes them from the JAX package.
COMPRESSION_KNOWN_ANSWERS = {
    (203, 0, 0, "float32", 256, 81, 27): ("a6e16bf503c4ed45", "0e04dadcfb373ddd"),
    (2**31 - 1, 2**31 - 1, 1, "float32", 25, 81, 9): ("25d99a25f14e264f", "836999d63effa771"),
    (0, 12_345, 0, "float64", 256, 81, 27): ("ccb244ed6d932929", "25996da80bb566b6"),
    (2**40 + 5, 7, 1, "float64", 25, 81, 9): ("81368606e948abe8", "53352c3ef11f80fc"),
    (42, 777, 1, "float32", 6, 5_000, 27): ("e74cecdd241f8536", "4374f739fd7244c1"),
}
# The compression phase's runs on the main path's data (N=256 ring,
# logistic, float32, eval every iteration), with T, the JAX package's
# iterations to ε=0.08 (jax 0.9.0 on a CPU, mixing 'stencil',
# use_mesh=False; both packages draw the same batches and compressor draws)
# and its floats transmitted. tests/test_torch_compression.py recomputes the
# counts. The gap cannot see the compressor (CHOCO keeps the network average
# whatever Q does), so k=9 at γ=0.1, whose count moves, is one of them; and
# constant-step compressed D-SGD is CHOCO op for op.
COMPRESSION_RUNS = {
    "choco_topk9": (dict(algorithm="choco", compression="top_k", compression_k=9,
                         choco_gamma=0.1), 3_000, 1_711, 27_648_000.0),
    "choco_randk27": (dict(algorithm="choco", compression="random_k", compression_k=27,
                           choco_gamma=0.3), 3_000, 1_480, 82_944_000.0),
    "gt_qsgd4": (dict(algorithm="gradient_tracking", compression="qsgd", compression_k=4,
                      choco_gamma=0.3), 3_000, 1_187, 41_952_000.0),
    "dsgd_randk27_const": (dict(algorithm="dsgd", compression="random_k", compression_k=27,
                                choco_gamma=0.3, lr_schedule="constant"), 3_000, 1_480,
                           82_944_000.0),
}
# The card-against-CPU float64 runs (N=8, T=200, pallas on the ring and on
# the fully-connected graph).
COMPRESSION_REFERENCE = (
    dict(algorithm="choco", compression="top_k", compression_k=3),
    dict(algorithm="choco", compression="random_k", compression_k=4),
    dict(algorithm="choco", compression="qsgd", compression_k=4),
    dict(algorithm="dsgd", compression="random_k", compression_k=4),
    dict(algorithm="gradient_tracking", compression="qsgd", compression_k=4),
)

# The topologies and push_sum phases' converging runs on the main path's
# data (logistic, 12,500 × 80 + bias, b=16, float32, seed 203) at N=256 on
# Erdős–Rényi of mean degree 12 (examples/bench_sparse_mixing.py's p =
# 12/N), eval every IRREGULAR_EVAL_EVERY, with T and the JAX package's
# iterations to ε=0.08 at the same config (jax 0.9.0 on a CPU,
# use_mesh=False; both packages draw the same batches).
# tests/test_torch_irregular.py recomputes them.
ER_P = 12 / 256
IRREGULAR_RUNS = {
    "dsgd_er256": (dict(algorithm="dsgd", topology="erdos_renyi", erdos_renyi_p=ER_P),
                   10_000, 9_650),
    "push_sum_der256": (dict(algorithm="push_sum", topology="directed_erdos_renyi",
                             erdos_renyi_p=ER_P), 10_000, 9_620),
}
IRREGULAR_EVAL_EVERY = 10
# Σ w at the end of the JAX package's push_sum_der256 run (same config, T).
# float32 rounds the column-stochastic weights 1/(1 + outdeg) so that a
# column sums to up to 5.2e-8 above 1: the mass grows by about that each mix
# in both packages (2.0e-4 of N over 10,000 mixes), where float64 keeps it
# to ~1e-12.
PUSH_SUM_MASS = 256.05198472738266
# The graph of dsgd_er256 at seed 203: (k_max, smallest degree, spectral gap).
ER_GRAPH = (22, 4, 0.22764039810695547)
# Chain and star at the study's N=25 (logistic, float64, eval every 10,
# STUDY_GRAPH_ITERATIONS): the JAX package's final objective f(x̄_T), its
# final gap plus its f* (jax 0.9.0 on a CPU, use_mesh=False), which the
# card's gap plus the port's f* must equal to 1e-12 (the two f* differ by
# about 8e-12: ROADMAP.md, Queue 3); recomputed by the same test.
STUDY_GRAPHS = {"chain": 0.5587360874625624, "star": 0.5532810079093404}
STUDY_GRAPH_ITERATIONS = 300
# The card-against-CPU float64 runs of the new graphs: T.
IRREGULAR_REFERENCE_ITERATIONS = 200
# docs/perf/sparse_mixing.json's end-to-end row: D-SGD on ER at N=1024 with
# mean degree 12, T=3,000 (L = 13 <= b, so the whole shard each step);
# eval every 100 so that the chunk replays as a graph.
ER_1024 = (1024, 12 / 1024, 3_000, 100)
# Push-sum on the undirected ring at N=256 (pallas against stencil), T.
PUSH_SUM_RING_ITERATIONS = 3_000
# The robust phase's variable-degree table: sign-flip on ER at N=64, p=0.1,
# seed 203 (degrees 3 to 13), on the main path's data, T, eval every 50;
# the graph's (k_max, smallest degree).
ER_ROBUST_ITERATIONS = 2_000
ER_ROBUST_GRAPH = (13, 3)
# docs/perf/robust_scale.json's crossover cell (examples/bench_robust_scale.py:
# N=64, ER at p=0.5, k_max 40, trimmed mean b=1 with no attack, d=40, b=16,
# shuffled, T=200): auto resolves to gather there.
ROBUST_CROSSOVER = dict(problem_type="logistic", algorithm="dsgd", topology="erdos_renyi",
                        n_workers=64, n_samples=3200, n_features=40, n_informative_features=20,
                        n_iterations=200, local_batch_size=16, eval_every=100,
                        partition="shuffled", erdos_renyi_p=0.5, aggregation="trimmed_mean",
                        robust_b=1, dtype="float32")


# The objectives phase: Huber and softmax. Huber at the main path's shapes
# (N=256 ring, regression data 12,500 × 80 + bias, L=49, the dense sampler,
# b=16); softmax at the study's N=25 ring with K=10 (d_model = 810, L=500,
# the gather sampler, which copies the class labels with the rows).
HUBER_MAIN = dict(problem_type="huber", n_workers=256, sampling_impl="dense")
SOFTMAX_STUDY = dict(problem_type="softmax")
# The float64 runs held card against CPU and against the JAX package: T and
# the eval cadence.
OBJECTIVE_ITERATIONS = 300
OBJECTIVE_EVAL_EVERY = 10
# The JAX package's float64 D-SGD gap after OBJECTIVE_ITERATIONS at those
# configs (jax 0.9.0 on a CPU, use_mesh=False, stencil; both packages draw
# the same batches and solve f* with the same scipy L-BFGS-B, so the f*
# agree bit for bit); tests/test_torch_huber.py and test_torch_softmax.py
# recompute them. The card's final gap must equal them to 1e-12 (rtol and
# atol: Huber's gap is in the thousands).
JAX_FINAL_GAPS = {"huber": 3391.257604294665, "softmax": 0.34749507923697154}
# The float32 runs whose iters/s are printed: T (eval every OBJECTIVE_EVAL_EVERY).
HUBER_ITERATIONS = 30_000
SOFTMAX_ITERATIONS = 10_000
# tests/test_huber.py's "exact methods pin the oracle" gate: GT and EXTRA at
# full batch, constant η = 0.05, float64, on its small config.
HUBER_ORACLE = dict(problem_type="huber", n_workers=8, n_samples=400, n_features=10,
                    n_informative_features=6, n_iterations=4_000, local_batch_size=50,
                    lr_schedule="constant", learning_rate_eta0=0.05, eval_every=400,
                    dtype="float64")
# CHOCO on the softmax study: top_k, and random_k, keep 81 of the 810
# columns. At the study's γ = 0.3 the top_k run amplifies rounding
# (``_top_k_agree``); at CHOCO_STABLE_GAMMA neither run does, and both are
# held on every leaf to 1e-12 (random_k has no ties to break).
SOFTMAX_TOP_K = 81
CHOCO_STABLE_GAMMA = 0.1
# The γ = 0.3 top_k run's estimates, card against CPU, through T: rounding
# grows about tenfold every 25 iterations (two CPU runs part by 6e-11 at
# T = 300), while a wrong value or pick shows at the scores' scale (~5e-3).
TOP_K_DRIFT = 1e-9
# examples/bench_compute_bound.py:125-136: N=8 ring, K=512, b = L = 2,048
# (the full-batch path), d = 4,096 and 8,192 features plus bias, D-SGD on
# its _random_dataset (default_rng(0): standard-normal X, uniform labels),
# f* = 0, no consensus; float32 under matmul_precision 'highest' and
# 'default'; stencil (the bench pins it) and pallas.
COMPUTE_BOUND = dict(problem_type="softmax", n_classes=512, algorithm="dsgd", n_workers=8,
                     local_batch_size=2048, n_informative_features=64,
                     record_consensus=False, dtype="float32")
COMPUTE_BOUND_FEATURES = (4096, 8192)
COMPUTE_BOUND_ITERATIONS = 200
COMPUTE_BOUND_EVAL_EVERY = 50
# The float32 'highest' run against a float64 CPU run of the same few
# iterations at d = 4,096: the gap within 1e-7 (rtol and atol) and the
# models within 1e-4 of their largest |x|. On an H100 'highest' read
# 2.5e-8 and 1.4e-6, TF32 ('default', 10 bits) 4.2e-7 and 3.3e-4: each
# limit lies between the two with room on both sides, and 'default' must
# land farther off.
COMPUTE_BOUND_CHECK_ITERATIONS = 3
# The bfloat16 phase. bench_compute_bound.py's d4096_bf16 and d8192_bf16
# cells (softmax K=512, N=8, b=2048) against the dense bfloat16 tensor-core
# peak; the card against the port's CPU run of main's config at a short T;
# the bfloat16 kernels' runs (ring_mix, ring_neighbor_sum, fc_mix,
# fc_neighbor_sum, the gather sampler), each short.
PEAK_BF16_FLOPS = 989e12
BF16_CPU_ITERATIONS = 100
BF16_FAULT_ITERATIONS = 1_000
BF16_SHORT_ITERATIONS = 500
# The card's bfloat16 run against the port's CPU run of the same config: the
# gap within GAP_ULPS bfloat16 ulps of f(x̄) at every eval, the most the CPU
# run measured against the JAX package's flat scan
# (tests/torch_bfloat16_agreement.py); the models' largest difference is
# printed.
BF16_GAP_ULPS = 7
# The bfloat16 layers: the robust cell's fused trimmed mean under 10% edge
# drops (its GT form launches the aggregator) and choco_randk27, each in
# bfloat16 beside float32, and the card against the port's CPU run of each
# at BF16_CPU_ITERATIONS.
BF16_LAYER_ITERATIONS = 1_000
BF16_LAYER_SEEDS = (0, 2**31 - 1)
BF16_LAYER_COUNTERS = (0, 2**32 + 5)
COMPUTE_BOUND_TOL = {"gap": 1e-7, "models": 1e-4}
# NVIDIA H100 SXM data sheet, dense: TF32 on the tensor cores (FP32 is
# PEAK_FLOPS["float32"], outside them).
PEAK_TF32_FLOPS = 495e12


# The federated phase: the JAX package's federated-scale cells, unsharded on
# one card, quadratic with 16 features in float32 (FEDERATED_BASE).
# (i) examples/bench_federated.py:205-220: ER at mean degree 12 (p = 12/N),
# n_samples = 2N, b = 4, T = 100 with an eval at 100; 'neighbor' at every
# N, 'dense' below its DENSE_SKIP_N. Each cell runs for FEDERATED_TIMED_T
# iterations with an eval every 100: its first eval is the cell's gap at
# 100 (the trajectory's prefix; the N=1,024 cell's own T=100 run is held
# bitwise to it), its 9 replays time the graph.
FEDERATED_BASE = dict(problem_type="quadratic", n_features=16, n_informative_features=10,
                      algorithm="dsgd", dtype="float32")
FEDERATED_SCALE_N = (1024, 4096, 10_000)
FEDERATED_DENSE_SKIP_N = 10_000
FEDERATED_SCALE_T = 100
FEDERATED_TIMED_T = 1_000
# (ii) examples/bench_worker_mesh.py:72-74's er_100k_p4_sparse on one card:
# 'auto' resolves to the matrix-free graph and the sparse sampler. Once
# fault-free and once under ER_100K_FAULTS, then float64 at ER_100K_F64_T
# against the CPU.
ER_100K = dict(topology="erdos_renyi", n_workers=100_000, erdos_renyi_p=16 / 100_000,
               topology_seed=1, n_samples=200_000, local_batch_size=4, n_iterations=50,
               eval_every=25)
ER_100K_FAULTS = dict(edge_drop_prob=0.1, participation_rate=0.5)
ER_100K_F64_T = 10
# sha256 (first 16 hex digits) of the cell's nbr_idx and nbr_mask bytes, from
# the JAX package's sparse sampler (tests/test_torch_matrix_free.py
# recomputes it).
ER_100K_DIGEST = "150f77251db3d2c9"
# (iii) examples/bench_mesh_scale.py:62-66's ring_1m_p16 on one card: one
# sample a worker, b = 1, T = 10 with an eval at 10 (timed as T = 100,
# an eval every 10).
RING_1M = dict(topology="ring", n_workers=1_000_000, n_samples=1_000_000, local_batch_size=1,
               topology_impl="neighbor", mixing_impl="gather")
RING_1M_T = 10
RING_1M_TIMED_T = 100
# The matrix-free kernels' rows: cell (ii)'s graph and processes (the path's
# shape), and the ring at N=256 under bursty drops, churn and participation.
SLOT_ROWS = {"er_100k": (ER_100K_FAULTS, ER_100K["n_iterations"]),
             "ring_256": (dict(edge_drop_prob=0.2, burst_len=8.0, mttf=60.0, mttr=25.0,
                               rejoin="neighbor_restart", participation_rate=0.7), 60)}
# The slot round's replica axis, checked at each SLOT_ROWS row.
SLOT_REPLICAS = 4
# The dense round past i·N + j = 2³²: a ring of this N.
DENSE_ROUND_N = 65_537


# The async event clock (phase async). examples/bench_async.py's base
# (quadratic N=32 ring, T=2,000, eval every 50, float32) and its four
# latency cells, each (fields, the JAX package's final gap, floats), from
# jax_backend.run on a CPU (tests/test_torch_async.py recomputes them; not
# docs/perf/async.json, which predates the JAX code as it stands), with
# the bench's speedup floors and final-gap envelopes against sync one-peer.
ASYNC_BENCH = dict(problem_type="quadratic", algorithm="dsgd", topology="ring", n_workers=32,
                   n_samples=1600, n_features=10, n_informative_features=6,
                   n_iterations=2000, local_batch_size=16, eval_every=50)
ASYNC_REFERENCE = {
    "constant": (dict(execution="async"), 53.573055267333984, 354068.0),
    "exponential": (dict(execution="async", latency_model="exponential"),
                    54.49319076538086, 354068.0),
    "lognormal": (dict(execution="async", latency_model="lognormal", latency_tail=1.25),
                  80.46687316894531, 354068.0),
    "pareto": (dict(execution="async", latency_model="pareto", latency_tail=1.3),
               186.8241424560547, 354068.0),
}
ASYNC_FLOORS = {"exponential": 2.0, "lognormal": 3.0, "pareto": 3.0}
ASYNC_ENVELOPES = {"constant": 1.25, "exponential": 1.3, "lognormal": 2.0}
ASYNC_GAP_TOLERANCE = 0.01
# bench_async.py's degenerate gate: N=16, T=200, float64, shared batches.
ASYNC_DEGENERATE = dict(n_workers=16, n_iterations=200, eval_every=50, n_samples=800,
                        dtype="float64")
# examples/bench_async_faults.py's cells (N=16 ring, T=800, lognormal 1.25,
# seed 7): healthy, churn 12/4 and participation 0.75 (float32; churn and
# thinning each at least 0.8× healthy's final gap, within 2× of each
# other), and GT under churn with participation 0.9 in float64, whose
# tracker residual |mean y − mean g_prev| stays under ASYNC_TRACKING_BOUND.
ASYNC_FAULTS_BENCH = dict(problem_type="quadratic", algorithm="dsgd", topology="ring",
                          n_workers=16, n_samples=1600, n_features=10,
                          n_informative_features=6, n_iterations=800, local_batch_size=16,
                          eval_every=50, execution="async", latency_model="lognormal",
                          latency_mean=1.0, latency_tail=1.25, seed=7)
ASYNC_FAULT_CELLS = {
    "healthy": {},
    "churn": dict(mttf=12.0, mttr=4.0),
    "thinning": dict(participation_rate=0.75),
    "gt_composed": dict(algorithm="gradient_tracking", dtype="float64", mttf=12.0, mttr=4.0,
                        participation_rate=0.9),
}
ASYNC_TRACKING_BOUND = 1e-9
# Main's shapes on the event clock: N=256 ring, logistic, d=81, L=49, b=16,
# lognormal 1.25, T=200 (51,200 events), eval every 10; the graph run
# against the same events run uncaptured at ASYNC_MAIN_UNCAPTURED rounds.
ASYNC_MAIN = dict(problem_type="logistic", algorithm="dsgd", topology="ring", n_workers=256,
                  n_iterations=200, eval_every=10, execution="async",
                  latency_model="lognormal", latency_tail=1.25)
ASYNC_MAIN_UNCAPTURED = 20
# Events/s of the event clock's cells in the graph at ed403b4, where the
# sampler was a launch an event (this script's async phase on that tree;
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's.
ASYNC_PARENT = {"constant": 25_605.6, "exponential": 25_595.8, "lognormal": 25_612.1,
                "pareto": 28_866.0, "faults healthy": 25_619.4, "faults churn": 21_639.9,
                "faults thinning": 21_652.7, "faults gt_composed": 15_215.0,
                "main's shapes": 22_598.0}
# The federated cells' graph iters/s at 57ca189, whose slot round took a
# warp a row in both launches (this script's federated phase on that tree;
# the same card and limit), printed beside this run's.
FEDERATED_PARENT = {"er_100k fault-free": 924.7, "er_100k faulted": 819.1}


class PhaseFailed(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def time_ms(torch, fn, n: int = TIMED_LAUNCHES) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, from CUDA
    event pairs. A sleep kernel first holds the stream, so the host queues
    every call before the card starts them and host gaps stay out (for a
    call of many operations the host may still fall behind)."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def graph_ms(torch, fn, n: int = TIMED_LAUNCHES, replays: int = 11) -> float:
    """Median time of one call of ``fn`` inside a CUDA graph of ``n`` calls,
    as the run loop launches a kernel: the graph captured once, then timed
    by CUDA events around each of ``replays`` replays, over ``n``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    graph.reset()
    return statistics.median(times)


def wall_ms(torch, fn, n: int = TIMED_LAUNCHES) -> float:
    """Wall-clock time of one call of ``fn`` in a loop of ``n`` with no
    sleep kernel ahead: host work and device time, whichever is longer."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _bound(nbytes: float, ops: float, dtype_name: str):
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the operations over the peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name: str, n: int, d: int, dtype_name: str, itemsize: int):
    """Ring and fc kernels: each input read once, the output written once."""
    arrays = 3 if name == "fused_ring_dsgd_step" else 2
    nbytes = arrays * n * d * itemsize + (itemsize if name == "fused_ring_dsgd_step" else 0)
    return _bound(nbytes, OPS_PER_ELEMENT[name] * n * d, dtype_name)


def compare_exchanges(width: int) -> int:
    """Compare-exchanges of the odd-even transposition network."""
    return sum(len(range(p % 2, width - 1, 2)) for p in range(width))


def robust_bound(rule: str, n: int, d: int, k: int, dtype_name: str, itemsize: int,
                 with_sgd: bool):
    """Robust kernels: x (and g) read once, out written once, the [N, k]
    int32 table and float32 liveness read once. Operations: for the count
    rules the network's 2·CE(k+1) min/max, k+1 selection adds and the
    count/divide per element; for clipping the norms (3·k·d per row), the
    clipped sum (4·k·d per row) and the adaptive ranking's network."""
    nbytes = (2 + with_sgd) * n * d * itemsize + 2 * n * k * 4 + 2 * itemsize
    if rule in ("trimmed_mean", "median"):
        ops = n * d * (2 * compare_exchanges(k + 1) + (k + 1) + 2)
    else:
        ops = n * (7 * k * d + d + 2 * compare_exchanges(k))
    return _bound(nbytes, ops + 2 * n * d * with_sgd, dtype_name)


def _nan_equal(torch, a, b) -> bool:
    return bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def _check_robust(torch, rule, got, want, tol32, what) -> float:
    """The count rules bitwise (NaN-aware); clipping within 1e-12 (rtol and
    atol, the JAX package's clipping tolerance) in float64 and ``tol32`` in
    float32. Returns the largest difference."""
    err = float(torch.nan_to_num((got - want).abs(), nan=0.0).max())
    if rule in ("trimmed_mean", "median"):
        check(_nan_equal(torch, got, want), f"{what}: not bitwise equal ({err:.3e})")
    else:
        tol = 1e-12 + 1e-12 * want.abs() if got.dtype == torch.float64 else tol32
        check(bool(torch.all((got - want).abs() <= tol)),
              f"{what}: {err:.3e} apart, beyond the tolerance")
    return err


def _robust_tol32(torch, x, live, nbr64):
    """float32 clipping: 1e-5 of the largest |x| in each row's closed
    neighbourhood, so the rows scaled by 1e4 loosen only their own."""
    row_max = x.abs().amax(1)
    nbhd_max = torch.maximum(row_max, torch.where(live > 0, row_max[nbr64], 0.0).amax(1))
    return 1e-5 * nbhd_max[:, None]


def _digest(np, objective) -> str:
    """Two trees whose runs print the same digest have bitwise-equal histories."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(objective).tobytes()).hexdigest()[:16]


def _record(name, err, ms, plain_ms, b_ms, b_by, lib_ms, **extra):
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{SOURCES[name]}",
            "replaces": REPLACES[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, **extra}


def phase_card(torch, kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(f"[card] {smi}")
    say(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls are not at full precision")
    say("[card] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False, float32 matmul precision 'highest'")
    build = kernels["build"]
    sources = [m.SOURCE for m in (kernels["rk"], kernels["fk"], kernels["bk"], kernels["sk"],
                                  kernels["ck"], kernels["dk"])]
    t0 = time.perf_counter()
    paths = build.build_all(sources)
    say(f"[card] built {', '.join(p.name for p in paths)} in parallel in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    return smi


def _ring_calls(torch, rk, name, x, g, eta, W, A):
    """(kernel call, plain call, library call) for one ring kernel."""
    if name == "fused_ring_dsgd_step":
        eta_f = float(eta.item())
        return (lambda: rk.fused_ring_dsgd_step(x, g, eta),
                lambda: rk.fused_ring_dsgd_step_plain(x, g, eta),
                lambda: torch.addmm(g, W, x, beta=-eta_f, alpha=1.0))
    if name == "ring_mix":
        return (lambda: rk.ring_mix(x), lambda: rk.ring_mix_plain(x),
                lambda: torch.matmul(W, x))
    return (lambda: rk.ring_neighbor_sum(x), lambda: rk.ring_neighbor_sum_plain(x),
            lambda: torch.matmul(A, x))


def _in_graph(torch, name, kernel, ms, b_ms):
    """The kernel's time a launch inside a captured graph (printed beside
    its event-timed time and bound); returns it in ms."""
    in_graph = graph_ms(torch, kernel)
    say(f"[kernels] {name:30s} in a graph of {TIMED_LAUNCHES} launches: {in_graph * 1e3:.3f} us "
        f"a launch (event-timed {ms * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us)")
    return in_graph


def _kernel_line(name, shape, dname, err, ms, plain_ms, lib_ms, b_ms, b_by, extra=""):
    lib = "library         —   " if lib_ms is None else f"library {lib_ms * 1e3:9.3f} us"
    say(f"[kernels] {name:30s} {shape} {dname}: max_abs_err {err:.3e} "
        f"kernel {ms * 1e3:9.3f} us  plain {plain_ms * 1e3:9.3f} us  {lib}  "
        f"bound {b_ms * 1e3:8.4f} us ({b_by}){extra}")


def ring_matrices(torch, topology, n: int, dtype):
    """(W, A, form) of the N-ring on the card: dense up to
    DENSE_LIBRARY_BYTES, else CSR with W's three weights of 1/3 a row."""
    if n * n * torch.finfo(dtype).bits // 8 <= DENSE_LIBRARY_BYTES:
        topo = topology.build_topology("ring", n)
        return (torch.as_tensor(topo.mixing_matrix, dtype=dtype, device="cuda"),
                torch.as_tensor(topo.adjacency, dtype=dtype, device="cuda"), "dense")
    i = torch.arange(n, device="cuda")

    def csr(offsets, weight):
        cols = torch.stack([(i + o) % n for o in offsets], 1).sort(1).values.flatten()
        crow = torch.arange(0, cols.numel() + 1, len(offsets), device="cuda")
        vals = torch.full((cols.numel(),), weight, dtype=dtype, device="cuda")
        return torch.sparse_csr_tensor(crow, cols, vals, size=(n, n), check_invariants=True)

    return csr((-1, 0, 1), 1.0 / 3.0), csr((-1, 1), 1.0), "CSR"


def launch_floor(torch, rk):
    """(empty kernel through the ctypes interface, one-element torch.neg),
    each timed as every kernel is: what a launch alone costs."""
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(torch, lambda: rk.launch_floor(one.device))
    op_ms = time_ms(torch, lambda: torch.neg(one))
    return floor_ms, op_ms


def kernels_ring(torch, rk, topology, gen, records, floor_ms):
    for n, d in SHAPES:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            x = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
            g = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
            eta = torch.tensor([0.05 / 7.0], dtype=dtype, device="cuda")
            W, A, form = ring_matrices(torch, topology, n, dtype)
            for name in rk.KERNELS:
                kernel, plain, library = _ring_calls(torch, rk, name, x, g, eta, W, A)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(torch.equal(got, want), f"{name} N={n} d={d} {dname}: not bitwise equal "
                                              f"to its plain version (max abs diff {err:.3e})")
                ms, plain_ms, lib_ms = time_ms(torch, kernel), time_ms(torch, plain), time_ms(torch, library)
                b_ms, b_by = bound(name, n, d, dname, x.element_size())
                _kernel_line(name, f"N={n:7d} d={d:5d}", dname, err, ms, plain_ms, lib_ms, b_ms, b_by,
                             extra=f" ({form})  floor +{(ms - floor_ms) * 1e3:.3f} us, "
                                   f"bound/kernel {b_ms / ms:.1%}")
                if (n, d) == MAIN_SHAPE and dtype == torch.float32:
                    records[name] = _record(name, err, ms, plain_ms, b_ms, b_by, lib_ms,
                                            graph_ms=_in_graph(torch, name, kernel, ms, b_ms))


def _fc_calls(torch, fk, name, x):
    """(kernel, plain, library reduction) calls of one fc kernel on x."""
    reduce = torch.mean if name == "fc_mix" else torch.sum
    return (lambda: getattr(fk, name)(x), lambda: getattr(fk, f"{name}_plain")(x),
            lambda: reduce(x, 0, keepdim=True))


def _fc_close(torch, got, want, x, what) -> float:
    """Within N·eps·max|x| of the plain version, which sums in another
    order; returns the largest difference."""
    err = float((got - want).abs().max())
    tol = x.shape[0] * torch.finfo(x.dtype).eps * float(x.abs().max())
    check(err <= tol,
          f"{what}: {err:.3e} from the plain version, beyond N·eps·max|x| = {tol:.3e}")
    return err


def kernels_fc(torch, fk, topology, gen, records, floor_ms):
    for n, d in FC_SHAPES:
        topo = topology.build_topology("fully_connected", n) if n <= FC_DENSE_MAX_N else None
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            x = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
            for name in fk.KERNELS:
                kernel, plain, library = _fc_calls(torch, fk, name, x)
                plan = fk.plan_for(name, x)
                got, want, mirror = kernel(), plain(), fk.MIRRORS[name](x, plan)
                torch.cuda.synchronize()
                err = _fc_close(torch, got, want, x, f"{name} N={n} d={d} {dname}")
                check(torch.equal(got, mirror), f"{name} N={n} d={d} {dname}: not bitwise equal "
                                                f"to the mirror of its order ({plan.describe()})")
                ms, plain_ms, lib_ms = time_ms(torch, kernel), time_ms(torch, plain), time_ms(torch, library)
                wall = wall_ms(torch, kernel)
                dense = ""
                if topo is not None:
                    mat = topo.mixing_matrix if name == "fc_mix" else topo.adjacency
                    mat = torch.as_tensor(mat, dtype=dtype, device="cuda")
                    dense_ms = time_ms(torch, lambda: torch.matmul(mat, x))
                    dense = f", dense matmul {dense_ms * 1e3:.3f} us"
                b_ms, b_by = bound(name, n, d, dname, x.element_size())
                _kernel_line(name, f"N={n:5d} d={d:5d}", dname, err, ms, plain_ms, lib_ms, b_ms, b_by,
                             extra=f"  floor +{(ms - floor_ms) * 1e3:.3f} us, bound/kernel "
                                   f"{b_ms / ms:.1%}, wall per call {wall * 1e3:.3f} us{dense}; "
                                   f"plan {plan.describe()}")
                if (n, d) == FC_RECORD_SHAPE and dtype == torch.float32:
                    records[name] = _record(name, err, ms, plain_ms, b_ms, b_by, lib_ms,
                                            plan=plan.describe(),
                                            graph_ms=_in_graph(torch, name, kernel, ms, b_ms))


def k15_table(np, topology, n: int, dead: float, seed: int):
    """A symmetric table of largest degree 15: the circulant graph over
    offsets 1, 2, 3, 5, 7, 11, 13 and the matching i ↔ i + n/2, with about
    ``dead`` of its edges down (both slots of an edge die together)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), dtype=np.float32)
    ids = np.arange(n)
    for o in (1, 2, 3, 5, 7, 11, 13):
        A[ids, (ids + o) % n] = A[(ids + o) % n, ids] = 1.0
    A[ids, (ids + n // 2) % n] = 1.0
    nbr, mask = topology.neighbor_table(A)
    if dead > 0:
        ei, ej = np.nonzero(np.triu(A, 1))
        drop = rng.random(len(ei)) < dead
        A[ei[drop], ej[drop]] = A[ej[drop], ei[drop]] = 0.0
    live = np.take_along_axis(A, nbr.astype(np.int64), axis=1) * mask
    return nbr, live.astype(np.float32)


def robust_inputs(np, topology):
    """(label, nbr, live, x) of the robust kernels' four inputs: the robust
    cell's ring, the k_max=15 table with dead slots and all live, and the
    robust phase's ER graph at N=64, d=81, whose rows hold 3 to 13 live
    slots of 13."""
    rng = np.random.default_rng(11)
    n, d = ROBUST_SHAPE
    nbr, mask = topology.neighbor_tables_for(topology.build_topology("ring", n))
    out = [("ring", nbr, mask.astype(np.float32), rng.standard_normal((n, d)))]
    for label, dead in (("k15-dead", 0.2), ("k15-live", 0.0)):
        nbr, live = k15_table(np, topology, 4096, dead, seed=5)
        x = rng.standard_normal((4096, 128))
        x[[1, 5, 77, 1000]] *= 1e4
        out.append((label, nbr, live, x))
    nbr, mask = topology.neighbor_tables_for(
        topology.build_topology("erdos_renyi", 64, erdos_renyi_p=0.1, seed=203))
    out.append(("er64", nbr, mask.astype(np.float32), rng.standard_normal((64, SAMPLING_D))))
    return out


def kernels_robust(torch, np, bk, topology, gather_factory, records):
    er_rows = {}
    for label, nbr_np, live_np, x_np in robust_inputs(np, topology):
        n, k = nbr_np.shape
        d = x_np.shape[1]
        real = float((nbr_np != np.arange(n)[:, None]).sum())
        dead = 1.0 - float(live_np.sum()) / real
        say(f"[kernels] robust input {label}: N={n} d={d} k_max={k}, {1.0 - real / (n * k):.1%} "
            f"of the slots padding, {dead:.1%} of the real slots dead")
        live = torch.as_tensor(live_np, device="cuda")
        nbr64 = torch.as_tensor(nbr_np, dtype=torch.int64, device="cuda")
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            tol32 = _robust_tol32(torch, x, live, nbr64)
            g = torch.randn(x.shape, device="cuda", dtype=dtype)
            eta = torch.tensor([0.05 / 7.0], dtype=dtype, device="cuda")
            for rule, ct in SCREENS:
                adaptive = rule == "clipped_gossip" and ct == 0.0
                tau = torch.tensor([ct], dtype=dtype, device="cuda")
                agg = bk.make_fused_robust_aggregator(rule, 1, nbr_np, ct, device="cuda")
                step = bk.make_fused_robust_dsgd_step(rule, 1, nbr_np, ct, device="cuda")
                gather = gather_factory(rule, 1, nbr_np, ct, device="cuda")
                variants = (
                    ("make_fused_robust_aggregator", lambda: agg(live, x),
                     lambda: bk.fused_robust_plain(rule, 1, nbr64, live, x, tau, adaptive=adaptive),
                     lambda: gather(live, x), False),
                    ("make_fused_robust_dsgd_step", lambda: step(live, x, g, eta),
                     lambda: bk.fused_robust_plain(rule, 1, nbr64, live, x, tau,
                                                   adaptive=adaptive, g=g, eta=eta),
                     lambda: gather(live, x) - eta * g, True),
                )
                for name, kernel, plain, gathered, with_sgd in variants:
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    err = _check_robust(torch, rule, got, want, tol32,
                                        f"{name} {rule} tau={ct} {label} {dname} vs plain")
                    ms, plain_ms, gather_ms = (time_ms(torch, kernel), time_ms(torch, plain),
                                               time_ms(torch, gathered))
                    b_ms, b_by = robust_bound(rule, n, d, k, dname, x.element_size(), with_sgd)
                    _kernel_line(f"{name[10:]} {rule[:8]} tau={ct}", f"{label:8s}", dname, err,
                                 ms, plain_ms, None, b_ms, b_by,
                                 extra=f"  gather form (multi-op) {gather_ms * 1e3:9.3f} us")
                    if (label, rule, ct, dtype) == (*ROBUST_RECORD, 0.0, torch.float32):
                        records[name] = _record(name, err, ms, plain_ms, b_ms, b_by, None,
                                                gather_ms=gather_ms,
                                                graph_ms=_in_graph(torch, name, kernel, ms, b_ms))
                    if label == "er64" and dtype == torch.float32:
                        in_graph = _in_graph(torch, f"{name[10:]} {rule[:8]} tau={ct} er64",
                                             kernel, ms, b_ms)
                        if (rule, ct) == (ROBUST_RECORD[1], 0.0):
                            er_rows[name] = dict(er64_graph_ms=in_graph, er64_ms=ms,
                                                 er64_plain_ms=plain_ms, er64_bound_ms=b_ms,
                                                 er64_gather_ms=gather_ms, er64_max_abs_err=err)
    for name, extra in er_rows.items():
        records[name].update(extra)


def phase_kernels(torch, np, kernels, topology, gather_factory):
    """Returns {kernel: record} at each kernel's path shape in float32."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    floor_ms, op_ms = launch_floor(torch, kernels["rk"])
    one = torch.zeros(1, device="cuda")
    floor_graph_ms = graph_ms(torch, lambda: kernels["rk"].launch_floor(one.device))
    say(f"[kernels] launch floor: empty kernel through ctypes {floor_ms * 1e3:.3f} us "
        f"({floor_graph_ms * 1e3:.3f} us a launch in a graph of {TIMED_LAUNCHES}), "
        f"one-element torch.neg {op_ms * 1e3:.3f} us")
    kernels_ring(torch, kernels["rk"], topology, gen, records, floor_ms)
    kernels_fc(torch, kernels["fk"], topology, gen, records, floor_ms)
    kernels_robust(torch, np, kernels["bk"], topology, gather_factory, records)
    say(f"[kernels] ported kernels: {', '.join(records)}")
    return {name: {**record, "floor_ms": floor_ms, "graph_floor_ms": floor_graph_ms}
            for name, record in records.items()}


def sampling_n_valid(torch, n: int, L: int, b: int):
    """Every shard full but three: an empty one, one of 3 rows, one of b − 1."""
    nv = torch.full((n,), L, dtype=torch.int64, device="cuda")
    nv[1], nv[2], nv[3] = 0, 3, b - 1
    return nv


def sampling_bound(form: str, n: int, L: int, b: int, itemsize: int, d: int = SAMPLING_D):
    """(ms, 'bytes' or 'operations') for one draw, in either form: 1 + N +
    N·L Threefry calls, the mantissa of each row (3 operations) and a top-k
    selection of each worker's k = min(b, L) rows, L·⌈log2 k⌉ compares (a
    heap of k), against t and n_valid read once and the output written
    once: the dense form's [N, L] weights; the gather form's k distinct
    rows of X and y a worker read, Xb [N, b, d], yb and the weights written."""
    k = min(b, L)
    select = n * L * max(1, math.ceil(math.log2(k)))
    ops = THREEFRY_OPS * (1 + n + n * L) + 3 * n * L + select
    if form == "sample_worker_batch_weights":
        moved = n * L * itemsize
    else:
        moved = n * k * (d + 1) * itemsize + n * b * (d + 2) * itemsize
    t_bytes = (8 + 8 * n + moved) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sampling_rows(torch, n: int, L: int, dtype):
    """The gather form's shards: X [N, L, SAMPLING_D] and y [N, L], from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(n * 100_003 + L)
    X = torch.randn((n, L, SAMPLING_D), generator=gen, device="cuda", dtype=dtype)
    return X, torch.randn((n, L), generator=gen, device="cuda", dtype=dtype)


def _same(torch, got, want) -> bool:
    return all(torch.equal(g, h) for g, h in zip(got, want))


def phase_sampling(torch, np, sk, sampling, prng):
    """The sampling kernels against their plain twin on the card, bitwise, in
    both forms and dtypes at every input of SAMPLING_SHAPES, seed, slot and
    counter: the dense weights, the gather form's indices and weights, and
    its gathered rows against ``gather_batches`` of the twin's indices; the
    known-answer digests of the JAX package's draws; each kernel's times at
    its path's input, and ``torch.topk`` of the same scores in a graph as a
    yardstick of the selection alone. Returns the kernels' records."""
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    checked = 0
    for label, n, L, b in SAMPLING_SHAPES:
        nv = sampling_n_valid(torch, n, L, b)
        for dname, seeds in SAMPLING_SEEDS.items():
            dtype = getattr(torch, dname)
            X, y = sampling_rows(torch, n, L, dtype)
            for seed in seeds:
                run_key = prng.key(seed, x64=dtype == torch.float64)
                for slot in SAMPLING_SLOTS:
                    key = prng.fold_in(run_key, slot)
                    for counter in SAMPLING_COUNTERS:
                        t.fill_(counter)
                        what = f"{label} N={n} L={L} b={b} {dname} seed={seed} slot={slot} t={counter}"
                        w = sk.sample_worker_batch_weights(key, t, nv, L, b, dtype)
                        check(torch.equal(w, sampling.sample_worker_batch_weights(
                            key, t, nv, L, b, dtype)), f"sampling weights {what}: not bitwise")
                        want = sampling.sample_batch_indices(key, t, nv, L, b, dtype)
                        check(_same(torch, sk.sample_batch_indices(key, t, nv, L, b, dtype), want),
                              f"sampling indices {what}: not bitwise")
                        check(_same(torch, sk.sample_worker_batches(key, t, X, y, nv, b),
                                    (*sampling.gather_batches(X, y, want[0]), want[1])),
                              f"sampling batches {what}: not bitwise gather_batches of the twin")
                        checked += 1
    say(f"[sampling] both kernels bitwise equal to the plain twin at {checked} inputs "
        f"({len(SAMPLING_SHAPES)} shapes, both dtypes, seeds, slots {SAMPLING_SLOTS}, "
        f"t {SAMPLING_COUNTERS}, ragged shards of 0, 3 and b - 1 rows): the weights, the "
        f"indices, and Xb, yb bitwise gather_batches of the twin's indices (d={SAMPLING_D})")
    for (seed, slot, counter, dname, n, L, b), want in KNOWN_ANSWERS.items():
        dtype = getattr(torch, dname)
        key = prng.fold_in(prng.key(seed, x64=dtype == torch.float64), slot)
        nv = sampling_n_valid(torch, n, L, b)
        t.fill_(counter)
        scores = sampling.masked_scores(key, t, nv, L, dtype)
        weights = sk.sample_worker_batch_weights(key, t, nv, L, b, dtype).to(torch.float32)
        indices, _ = sk.sample_batch_indices(key, t, nv, L, b, dtype)
        got = tuple(_digest(np, a.cpu().numpy()) for a in (scores, weights, indices))
        say(f"[sampling] known answer seed={seed} slot={slot} t={counter} {dname} N={n} L={L} "
            f"b={b}: scores, weights, indices {' '.join(got)} "
            f"({'equal to' if got == want else 'NOT'} jax 0.9.0's)")
        check(got == want, f"sampling known answer {seed, slot, counter, dname}: {got} != {want}")
    records = {}
    for name, (label, n, L, b) in SAMPLING_RECORD.items():
        nv = sampling_n_valid(torch, n, L, b)
        key = prng.fold_in(prng.key(203, x64=False), 0)
        t.fill_(12_345)
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            X, y = sampling_rows(torch, n, L, dtype)
            if name == "sample_worker_batch_weights":
                kernel = lambda: sk.sample_worker_batch_weights(key, t, nv, L, b, dtype)  # noqa: E731
                plain = lambda: sampling.sample_worker_batch_weights(key, t, nv, L, b, dtype)  # noqa: E731
            else:
                kernel = lambda: sk.sample_worker_batches(key, t, X, y, nv, b)  # noqa: E731
                plain = lambda: sampling.sample_worker_batches(key, t, X, y, nv, b)  # noqa: E731
            got, want = kernel(), plain()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            err = max(float((g.double() - h.double()).abs().max()) for g, h in zip(got, want))
            check(_same(torch, got, want),
                  f"sampling {name} at its timed input {dname}: not bitwise (max diff {err:.3e})")
            ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            b_ms, b_by = sampling_bound(name, n, L, b, dtype.itemsize)
            _kernel_line(name, f"{label} N={n} L={L} b={b}", dname, err, ms, plain_ms, None,
                         b_ms, b_by)
            if dtype == torch.float32:
                records[name] = _record(name, err, ms, plain_ms, b_ms, b_by, None,
                                        graph_ms=_in_graph(torch, name, kernel, ms, b_ms))
                scores = sampling.masked_scores(key, t, nv, L, dtype)
                topk_ms = graph_ms(torch, lambda: torch.topk(scores, min(b, L), dim=-1))
                say(f"[sampling] yardstick torch.topk(scores [{n}, {L}], {min(b, L)}) {dname} in a "
                    f"graph of {TIMED_LAUNCHES}: {topk_ms * 1e3:.3f} us a call (selection only, "
                    f"not the function)")
    for n, L in SAMPLING_PLAN_SHAPES:
        nv = torch.full((n,), L, dtype=torch.int64, device="cuda")
        cluster = min(8, 1 << math.ceil(math.log2(L / 1024)))
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0)
            scores = sk.draw_scores(key, 12_345, nv, L, dtype)
            one = lambda: sk._select(scores, 16, dtype)  # noqa: E731
            clustered = lambda: sk._select(scores, 16, dtype, cluster=cluster)  # noqa: E731
            want = sampling.sample_batch_indices(key, 12_345, nv, L, 16, dtype)[0]
            check(torch.equal(one(), want) and torch.equal(clustered(), want),
                  f"sampling plan N={n} L={L} {dname}: not the twin's indices")
            us = [graph_ms(torch, f) * 1e3 for f in (one, clustered, clustered, one)]
            say(f"[sampling] plan N={n} L={L} b=16 {dname}: one block, 8 rows a thread "
                f"{us[0]:.3f} {us[3]:.3f} us; a cluster of {cluster} blocks, a thread a row "
                f"{us[1]:.3f} {us[2]:.3f} us (the selection on the draw's scores, in a graph of "
                f"{TIMED_LAUNCHES}; both bitwise the twin)")
    sampling_long(torch, sk, sampling, prng)
    return records


def sampling_long(torch, sk, sampling, prng):
    """Both forms on a shard past 65,536 rows (SAMPLING_LONG): the gather
    form's indices, weights and rows bitwise the twin, the dense weights
    bitwise the twin's gather draw scattered (the dense twin holds L²
    pairs), at N=1 and with ragged shards at N=4, in both dtypes, at two
    seeds and counters; then each form's times at N=1 in a graph and
    event-timed, beside the twin's gather draw and the bound."""
    n1, L, b = SAMPLING_LONG
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    checked = 0
    for n in (n1, 4):
        nv = (torch.full((n,), L, dtype=torch.int64, device="cuda") if n == n1
              else sampling_n_valid(torch, n, L, b))
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            X, y = sampling_rows(torch, n, L, dtype)
            for seed in (42, 2**31 - 1):
                key = prng.fold_in(prng.key(seed, x64=dtype == torch.float64), 1)
                for counter in (0, 2**31 - 1):
                    t.fill_(counter)
                    what = f"long shard N={n} L={L} b={b} {dname} seed={seed} t={counter}"
                    idx, w = sampling.sample_batch_indices(key, t, nv, L, b, dtype)
                    check(_same(torch, sk.sample_batch_indices(key, t, nv, L, b, dtype), (idx, w)),
                          f"sampling indices {what}: not bitwise")
                    check(_same(torch, sk.sample_worker_batches(key, t, X, y, nv, b),
                                (*sampling.gather_batches(X, y, idx), w)),
                          f"sampling batches {what}: not bitwise gather_batches of the twin")
                    dense = torch.zeros((n, L), dtype=dtype, device="cuda").scatter_add_(1, idx, w)
                    check(torch.equal(sk.sample_worker_batch_weights(key, t, nv, L, b, dtype), dense),
                          f"sampling weights {what}: not the twin's gather draw scattered")
                    checked += 1
    say(f"[sampling] long shard L={L} b={b}: both forms bitwise the twin at {checked} inputs (N=1 "
        f"and N=4 with shards of {L}, 0, 3 and {b - 1} rows; both dtypes; seeds 42, 2^31 - 1; "
        f"t 0, 2^31 - 1; the dense weights against the twin's gather draw scattered)")
    nv = torch.full((n1,), L, dtype=torch.int64, device="cuda")
    key = prng.fold_in(prng.key(203, x64=False), 0)
    t.fill_(12_345)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        X, y = sampling_rows(torch, n1, L, dtype)
        plain_ms = time_ms(torch, lambda: sampling.sample_worker_batches(key, t, X, y, nv, b))
        for name, kernel in (
                ("sample_worker_batches", lambda: sk.sample_worker_batches(key, t, X, y, nv, b)),
                ("sample_worker_batch_weights",
                 lambda: sk.sample_worker_batch_weights(key, t, nv, L, b, dtype))):
            ms, in_graph = time_ms(torch, kernel), graph_ms(torch, kernel)
            b_ms, b_by = sampling_bound(name, n1, L, b, dtype.itemsize)
            say(f"[sampling] long shard {name} N={n1} L={L} b={b} {dname}: in a graph of "
                f"{TIMED_LAUNCHES} {in_graph * 1e3:.3f} us, event-timed {ms * 1e3:.3f} us, twin's "
                f"gather draw {plain_ms * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us ({b_by})")


def _agree(label, card, host, tol=1e-12, phase="reference"):
    diff = float(abs(card.history.objective - host.history.objective).max())
    models = float(abs(card.final_models - host.final_models).max())
    say(f"[{phase}] {label} on the card vs plain on the CPU: max gap diff {diff:.3e}, "
        f"max model diff {models:.3e}")
    check(diff <= tol and models <= tol, f"{label}: card and CPU runs disagree beyond {tol}")


def phase_reference(torch, pkg, rk, bk):
    cfg = pkg.ExperimentConfig(
        problem_type="logistic", n_workers=8, n_samples=400, n_features=10,
        n_informative_features=6, n_iterations=200, local_batch_size=8,
        mixing_impl="pallas", sampling_impl="dense", dtype="float64",
    )
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    _agree("N=8 T=200 float64 pallas", pkg.run(cfg, ds, f_opt, device="cuda"),
           pkg.run(cfg, ds, f_opt, device="cpu"))
    admm = cfg.replace(algorithm="admm")
    rk.reset_launch_counts()
    card = pkg.run(admm, ds, f_opt, device="cuda")
    check(rk.LAUNCHES["ring_neighbor_sum"] == admm.n_iterations + 1,
          f"admm: ring_neighbor_sum launched {rk.LAUNCHES} times, not T+1")
    _agree("N=8 T=200 float64 admm pallas", card, pkg.run(admm, ds, f_opt, device="cpu"))
    robust = cfg.replace(n_workers=12, n_samples=480, partition="shuffled",
                         attack="sign_flip", n_byzantine=2, attack_scale=2.0)
    ds = pkg.generate_synthetic_dataset(robust)
    _, f_opt = pkg.compute_reference_optimum(ds, robust.reg_param)
    for rule in ("trimmed_mean", "clipped_gossip"):
        rcfg = robust.replace(aggregation=rule, robust_b=1, robust_impl="fused")
        bk.reset_launch_counts()
        card = pkg.run(rcfg, ds, f_opt, device="cuda")
        check(bk.LAUNCHES["make_fused_robust_dsgd_step"] == rcfg.n_iterations,
              f"the fused robust step launched {bk.LAUNCHES} times, not T")
        _agree(f"N=12 T=200 float64 sign_flip {rule} fused", card,
               pkg.run(rcfg, ds, f_opt, device="cpu"))


def _converging_run(torch, pkg, counters, cfg, ds, f_opt, label, measure_timestamps=False,
                    converges=True, return_state=False):
    """One run on the card with its launch counts; it must stay finite and,
    where ``converges``, cross ε within T."""
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    res = pkg.run(cfg, ds, f_opt, device="cuda", measure_timestamps=measure_timestamps,
                  return_state=return_state)
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    h = res.history
    crossed = pkg.iterations_to_threshold(h.objective, cfg.suboptimality_threshold,
                                          h.eval_iterations)
    import numpy as np

    loop = "measured chunk loop" if measure_timestamps else "graph"
    say(f"[{label}] N={cfg.n_workers} T={cfg.n_iterations} {cfg.topology} {cfg.mixing_impl} "
        f"({loop}): "
        f"iters-to-{cfg.suboptimality_threshold} = {crossed}, final gap {h.objective[-1]:.6f}, "
        f"consensus {h.consensus_error[-1]:.3e}, {h.iters_per_second:.1f} iters/s "
        f"(warm-up and capture {h.compile_seconds:.2f} s, whole run {wall:.2f} s, "
        f"{cfg.n_iterations / wall:.1f} iters/s over it), kernel launches {launches}, "
        f"gap history sha256 {_digest(np, h.objective)}")

    check(h.objective.shape == (cfg.n_iterations // cfg.eval_every,), "gap history has the wrong shape")
    check(bool(np.all(np.isfinite(h.objective))), "non-finite gaps")
    check(not converges or 0 < crossed <= cfg.n_iterations,
          f"never reached ε={cfg.suboptimality_threshold} within T={cfg.n_iterations}")
    return res, launches


def _graph_equals_measured(torch, np, pkg, counters, cfg, ds, f_opt, label, graph, launches,
                           converges=True):
    """The same run with ``measure_timestamps=True`` (no graph): its gap
    history, final models and launch counts bitwise the graph run's."""
    measured, counted = _converging_run(torch, pkg, counters, cfg, ds, f_opt, label,
                                        measure_timestamps=True, converges=converges)
    same = (np.array_equal(graph.history.objective, measured.history.objective)
            and np.array_equal(graph.final_models, measured.final_models))
    say(f"[{label}] graph run vs measured chunk loop: gap history and final models "
        f"{'bitwise equal' if same else 'DIFFER'}, launches {launches} vs {counted}; iters/s "
        f"graph {graph.history.iters_per_second:.1f}, measured "
        f"{measured.history.iters_per_second:.1f} "
        f"({graph.history.iters_per_second / measured.history.iters_per_second:.2f}x)")
    check(same, f"{label}: the graph run is not bitwise its measure_timestamps=True run")
    check({k: v for k, v in counted.items() if v} == {k: v for k, v in launches.items() if v},
          f"{label}: launch counts {launches} (graph) vs {counted}")


def phase_parity(torch, np, pkg, rk, sk):
    cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                               mixing_impl="pallas", dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    res, launches = _converging_run(torch, pkg, [rk, sk], cfg, ds, f_opt, "parity")
    say("[parity] reference Table I: 9927 iterations")
    for kernel in ("fused_ring_dsgd_step", "sample_worker_batches"):
        check(launches[kernel] == cfg.n_iterations,
              f"{kernel} launched {launches[kernel]} times, not T")
    _graph_equals_measured(torch, np, pkg, [rk, sk], cfg, ds, f_opt, "parity", res, launches)
    return launches


def phase_main(torch, np, pkg, rk, sk, T):
    cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                               n_workers=256, n_iterations=T, mixing_impl="pallas",
                               dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    runs = {}
    launches = None
    for impl in ("pallas", "stencil"):
        res, counted = _converging_run(torch, pkg, [rk, sk], cfg.replace(mixing_impl=impl),
                                       ds, f_opt, "main")
        check(float(res.history.consensus_error[-1]) < 1.0, "consensus error not below 1.0")
        check(counted["sample_worker_batch_weights"] == T,
              f"sampling kernel launched {counted['sample_worker_batch_weights']} times, not T={T}")
        runs[impl] = res
        if impl == "pallas":
            launches = counted
            check(counted["fused_ring_dsgd_step"] == T,
                  f"fused kernel launched {counted['fused_ring_dsgd_step']} times, not T={T}")
            _graph_equals_measured(torch, np, pkg, [rk, sk], cfg.replace(mixing_impl=impl), ds,
                                   f_opt, "main", res, counted)
    gap_diff = float(abs(runs["pallas"].history.objective - runs["stencil"].history.objective).max())
    say(f"[main] sampling dense (L={max(len(s) for s in ds.shard_indices)}), T={T}: "
        f"largest |gap(pallas) - gap(stencil)| = {gap_diff:.3e}")
    return runs["pallas"], launches


def phase_mixing(torch, pkg, rk, final_models):
    topo = pkg.build_topology("ring", final_models.shape[0])
    op = pkg.make_mixing_op(topo, "pallas")
    x = torch.as_tensor(final_models, dtype=torch.float32, device="cuda").contiguous()
    rk.reset_launch_counts()
    mixed, summed = op.apply(x), op.neighbor_sum(x)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    import numpy as np

    x64 = x.double().cpu().numpy()
    err_w = float(np.abs(mixed.double().cpu().numpy() - topo.mixing_matrix @ x64).max())
    err_a = float(np.abs(summed.double().cpu().numpy() - topo.adjacency @ x64).max())
    scale = float(np.abs(x64).max())
    say(f"[mixing] MixingOp(pallas) on the N={x.shape[0]} final models: "
        f"|Wx - dense| {err_w:.3e}, |Ax - dense| {err_a:.3e} (max |x| {scale:.3e}), "
        f"launches {launches}")
    check(err_w <= 1e-6 * max(scale, 1.0) and err_a <= 2e-6 * max(scale, 1.0),
          "MixingOp(pallas) disagrees with the dense W/A beyond float32 rounding")
    return launches


def phase_fc(torch, np, pkg, fk):
    cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd",
                               topology="fully_connected", mixing_impl="pallas",
                               dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    pallas, launches = _converging_run(torch, pkg, [fk], cfg, ds, f_opt, "fc")
    say("[fc] reference Table I (fully connected): 9596 iterations")
    check(launches["fc_mix"] == cfg.n_iterations,
          f"fc_mix launched {launches['fc_mix']} times, not T={cfg.n_iterations}")
    _graph_equals_measured(torch, np, pkg, [fk], cfg, ds, f_opt, "fc", pallas, launches)
    stencil, _ = _converging_run(torch, pkg, [fk], cfg.replace(mixing_impl="stencil"), ds,
                                 f_opt, "fc")
    rel = _relative_gap_diff(np, pallas, stencil)
    say(f"[fc] float32: largest |gap(stencil) - gap(pallas)| / |gap(pallas)| = {rel:.3e}")
    # fc_mix and torch.mean sum the column in different orders, so each step
    # differs by about an ulp; with every worker averaged to one model the
    # run does not damp those, and over T steps in float32 they add up to
    # about 2e-4 of the gap (PERF.md). Held to 1e-3.
    check(rel <= 1e-3, "the stencil run's gap history is not within 1e-3 relative of pallas")
    # The second witness: the same pair in float64, where an ulp is 2^29
    # times smaller. Rounding alone shrinks the difference by about as much;
    # a fault in the kernel would not shrink.
    cfg64 = cfg.replace(dtype="float64")
    runs64 = [_converging_run(torch, pkg, [fk], cfg64.replace(mixing_impl=impl), ds, f_opt,
                              "fc")[0] for impl in ("pallas", "stencil")]
    rel64 = _relative_gap_diff(np, *runs64)
    say(f"[fc] float64: largest |gap(stencil) - gap(pallas)| / |gap(pallas)| = {rel64:.3e}")
    check(rel64 <= 1e-10, "the float64 stencil run is not within 1e-10 relative of pallas")
    return launches


def _relative_gap_diff(np, a, b) -> float:
    ga, gb = a.history.objective, b.history.objective
    return float(np.max(np.abs(gb - ga) / np.abs(ga)))


def phase_admm(torch, np, pkg, rk, fk, T=ADMM_ITERATIONS):
    """Decentralized ADMM on the main path's data, float32, eval every
    iteration: the N=256 ring and the N=25 fully-connected graph, each with
    ``mixing_impl='pallas'`` and ``'stencil'``. Every run crosses ε within T,
    stays finite and ends with consensus below 1.0; the pallas runs launch
    their neighbour-sum kernel T+1 times (once at init, once an iteration)
    and no mixing kernel. The ring pair is bitwise equal (the kernel is
    bitwise its plain version); the fc pair within 1e-3 relative (the fc
    phase's gate: two summation orders). Returns the pallas runs' launches."""
    launches = {}
    for topology, n, kernel in (("ring", 256, "ring_neighbor_sum"),
                                ("fully_connected", 25, "fc_neighbor_sum")):
        cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="admm", topology=topology,
                                   n_workers=n, n_iterations=T, dtype="float32", eval_every=1)
        ds = pkg.generate_synthetic_dataset(cfg)
        _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
        runs = {}
        for impl in ("pallas", "stencil"):
            res, counted = _converging_run(torch, pkg, [rk, fk], cfg.replace(mixing_impl=impl),
                                           ds, f_opt, "admm")
            check(float(res.history.consensus_error[-1]) < 1.0,
                  f"admm {topology} {impl}: consensus error not below 1.0")
            want = {name: 0 for name in counted}
            if impl == "pallas":
                want[kernel] = T + 1
                launches[kernel] = counted
            check(counted == want, f"admm {topology} {impl}: launches {counted}, not {want}")
            runs[impl] = res.history
        pallas, stencil = runs["pallas"].objective, runs["stencil"].objective
        rel = float(np.max(np.abs(stencil - pallas) / np.abs(pallas)))
        say(f"[admm] {topology} N={n}: pallas and stencil histories "
            f"{'bitwise equal' if np.array_equal(pallas, stencil) else 'differ'}, largest "
            f"relative gap difference {rel:.3e}; sampling "
            f"{cfg.resolved_sampling_impl('cuda', max(len(s) for s in ds.shard_indices))}")
        ref = ADMM_REFERENCE[topology]
        say(f"[admm] ADMM_REFERENCE {topology} N={n} (JAX package, CPU, float32): "
            f"iters-to-0.08 {ref['iters_to_eps']}, final gap {ref['final_gap']}, consensus "
            f"{ref['consensus']}; port on the card: iters-to-0.08 "
            f"{pkg.iterations_to_threshold(pallas, 0.08, runs['pallas'].eval_iterations)}, "
            f"final gap {pallas[-1]:.6f}, floats {runs['pallas'].total_floats_transmitted:.6g}")
        if topology == "ring":
            check(np.array_equal(pallas, stencil),
                  "admm ring: the pallas and stencil gap histories are not bitwise equal")
        else:
            check(rel <= 1e-3, "admm fc: the stencil run is not within 1e-3 relative of pallas")
    return launches


def _within_count(label, crossed, want):
    check(abs(crossed - want) <= COUNT_TOLERANCE * want,
          f"{label}: {crossed} iterations to ε, not within {COUNT_TOLERANCE:.0%} of the JAX "
          f"package's {want}")


def phase_tracking(torch, np, pkg, kernels):
    """Gradient tracking, EXTRA and D-SGD with τ = 3 local steps on the main
    path's data (N=256 ring, float32, eval every iteration), each with
    ``mixing_impl='pallas'`` and ``'stencil'``: finite, and iterations to ε
    within 1% of the JAX package's count (TRACKING_RUNS). The pallas runs
    launch ``ring_mix`` 2T (GT) or T (EXTRA) times, or ``fused_ring_dsgd_step``
    T times (D-SGD), the stencil runs none, and every run the sampling kernel
    once a gradient call (T, or 3T with τ = 3); the GT and EXTRA pallas runs
    are bitwise their ``measure_timestamps=True`` runs. Then short float64
    runs of each on the card against the CPU (1e-12), and GT under sign-flip
    with the fused trimmed mean on the robust cell, whose aggregator launches
    twice an iteration. Returns the launches of the GT pallas run."""
    rk, bk, sk = kernels["rk"], kernels["bk"], kernels["sk"]
    counters = [rk, kernels["fk"], bk, sk]
    base = pkg.ExperimentConfig(problem_type="logistic", topology="ring", n_workers=256,
                                dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param)
    gt_launches = None
    for name, (fields, T, want) in TRACKING_RUNS.items():
        cfg = base.replace(n_iterations=T, **fields)
        grads = cfg.local_steps
        for impl in ("pallas", "stencil"):
            run_cfg = cfg.replace(mixing_impl=impl)
            res, counted = _converging_run(torch, pkg, counters, run_cfg, ds, f_opt, "tracking")
            h = res.history
            crossed = pkg.iterations_to_threshold(h.objective, 0.08, h.eval_iterations)
            say(f"[tracking] {name} {impl}: iters-to-0.08 {crossed}, JAX package {want} "
                f"({(crossed - want) / want:+.2%}), floats {h.total_floats_transmitted:.6g}")
            _within_count(f"tracking {name} {impl}", crossed, want)
            expect = {k: 0 for k in counted}
            expect["sample_worker_batch_weights"] = grads * T
            if impl == "pallas":
                kernel = "fused_ring_dsgd_step" if fields["algorithm"] == "dsgd" else "ring_mix"
                expect[kernel] = (2 if name == "gradient_tracking" else 1) * T
            check(counted == expect, f"tracking {name} {impl}: launches {counted}, not {expect}")
            if impl == "pallas" and name != "dsgd_tau3":
                _graph_equals_measured(torch, np, pkg, counters, run_cfg, ds, f_opt,
                                       "tracking", res, counted)
            if name == "gradient_tracking" and impl == "pallas":
                gt_launches = counted
    small = pkg.ExperimentConfig(
        problem_type="logistic", n_workers=8, n_samples=400, n_features=10,
        n_informative_features=6, n_iterations=200, local_batch_size=8, mixing_impl="pallas",
        sampling_impl="dense", dtype="float64",
    )
    sds = pkg.generate_synthetic_dataset(small)
    _, sf = pkg.compute_reference_optimum(sds, small.reg_param)
    for name, (fields, _, _) in TRACKING_RUNS.items():
        cfg = small.replace(**fields)
        _agree(f"N=8 T=200 float64 {name} pallas", pkg.run(cfg, sds, sf, device="cuda"),
               pkg.run(cfg, sds, sf, device="cpu"))
    robust = robust_config(pkg, TRACKING_ROBUST_ITERATIONS).replace(
        algorithm="gradient_tracking", attack="sign_flip", n_byzantine=12, attack_scale=5.0,
        aggregation="trimmed_mean", robust_b=1, robust_impl="fused")
    rds = pkg.generate_synthetic_dataset(robust)
    _, rf = pkg.compute_reference_optimum(rds, robust.reg_param)
    runs = _screened_runs(pkg, {"gt_signflip_trimmed_mean": robust}, rds, rf, counters,
                          "tracking")
    res, launches = runs["gt_signflip_trimmed_mean"]
    T = robust.n_iterations
    check(launches.get("make_fused_robust_aggregator") == 2 * T
          and "make_fused_robust_dsgd_step" not in launches,
          f"tracking GT sign-flip: launches {launches}, not the aggregator 2T = {2 * T} times")
    check(bool(np.all(np.isfinite(res.history.objective))), "tracking GT sign-flip: non-finite")
    return gt_launches, launches

def _main_data(pkg, n: int):
    """The main path's data split over n workers, and its optimum."""
    cfg = pkg.ExperimentConfig(problem_type="logistic", n_workers=n)
    ds = pkg.generate_synthetic_dataset(cfg)
    return ds, pkg.compute_reference_optimum(ds, cfg.reg_param)[1]


def _only(counted, **want):
    """The launch counts ``want``, and 0 for every other counted kernel."""
    return {name: want.get(name, 0) for name in counted}


def phase_topologies(torch, np, pkg, kernels):
    """The irregular graphs on the card. D-SGD on Erdős–Rényi at N=256 (p =
    12/256, IRREGULAR_RUNS) under mixing 'auto' (the dense product), 'gather'
    and 'sparse', T=10,000, eval every 10: each crosses ε within 1% of the
    JAX package's count, launches the dense sampling kernel once an
    iteration and no other kernel, and is bitwise its
    ``measure_timestamps=True`` run; the same three in float64 (T=200) on
    the card against the CPU to 1e-12. Chain and star at the study's N=25 in
    float64, card against CPU to 1e-12 and the final gap against the JAX
    package's (STUDY_GRAPHS) to 1e-12. ER at N=1024 (ER_1024, the whole
    shard each step) under the three forms: finite, iters/s of each."""
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on for float32 matmuls")
    counters = [kernels[k] for k in ("rk", "fk", "bk", "sk")]
    ds, f_opt = _main_data(pkg, 256)
    fields, T, want = IRREGULAR_RUNS["dsgd_er256"]
    cfg = pkg.ExperimentConfig(problem_type="logistic", n_workers=256, n_iterations=T,
                               eval_every=IRREGULAR_EVAL_EVERY, dtype="float32", **fields)
    topo = pkg.build_topology(cfg.topology, 256, erdos_renyi_p=cfg.erdos_renyi_p,
                              seed=cfg.resolved_topology_seed())
    graph = (int(topo.degrees.max()), int(topo.degrees.min()), topo.spectral_gap)
    say(f"[topologies] ER N=256 p={cfg.erdos_renyi_p:.6f} seed {cfg.resolved_topology_seed()}: "
        f"k_max {graph[0]}, smallest degree {graph[1]}, spectral gap {graph[2]:.6f}")
    check(graph[:2] == ER_GRAPH[:2] and abs(graph[2] - ER_GRAPH[2]) <= 1e-12,
          f"the ER graph is {graph}, not the JAX package's {ER_GRAPH}")
    runs = {}
    for impl in ("auto", "gather", "sparse"):
        run_cfg = cfg.replace(mixing_impl=impl)
        res, counted = _converging_run(torch, pkg, counters, run_cfg, ds, f_opt, "topologies")
        h = res.history
        crossed = pkg.iterations_to_threshold(h.objective, 0.08, h.eval_iterations)
        say(f"[topologies] dsgd ER {impl}: iters-to-0.08 {crossed}, JAX package {want} "
            f"({(crossed - want) / want:+.2%}), floats {h.total_floats_transmitted:.6g}")
        _within_count(f"topologies dsgd ER {impl}", crossed, want)
        expect = _only(counted, sample_worker_batch_weights=T)
        check(counted == expect, f"topologies dsgd ER {impl}: launches {counted}, not {expect}")
        _graph_equals_measured(torch, np, pkg, counters, run_cfg, ds, f_opt, "topologies", res,
                               counted)
        runs[impl] = res
    for impl in ("gather", "sparse"):
        rel = _relative_gap_diff(np, runs["auto"], runs[impl])
        say(f"[topologies] float32 ER: largest relative gap difference, dense vs {impl}: "
            f"{rel:.3e}")
    small = cfg.replace(dtype="float64", n_iterations=IRREGULAR_REFERENCE_ITERATIONS)
    for impl in ("auto", "gather", "sparse"):
        run_cfg = small.replace(mixing_impl=impl)
        _agree(f"ER N=256 T={small.n_iterations} float64 {impl}",
               pkg.run(run_cfg, ds, f_opt, device="cuda"), pkg.run(run_cfg, ds, f_opt, device="cpu"),
               phase="topologies")
    study = pkg.ExperimentConfig(problem_type="logistic", dtype="float64", eval_every=10,
                                 n_iterations=STUDY_GRAPH_ITERATIONS)
    sds, sf = _main_data(pkg, study.n_workers)
    for name, jax_objective in STUDY_GRAPHS.items():
        run_cfg = study.replace(topology=name)
        card, host = pkg.run(run_cfg, sds, sf, device="cuda"), pkg.run(run_cfg, sds, sf, device="cpu")
        _agree(f"{name} N=25 T={study.n_iterations} float64", card, host, phase="topologies")
        gap = float(card.history.objective[-1])
        say(f"[topologies] {name} N=25 float64: final gap card {gap!r}, CPU "
            f"{float(host.history.objective[-1])!r}; f(x̄_T) card {gap + sf!r}, JAX package "
            f"{jax_objective!r} ({gap + sf - jax_objective:+.3e}); spectral gap "
            f"{card.history.spectral_gap:.6f}")
        check(abs(gap + sf - jax_objective) <= 1e-12,
              f"{name}: the card's final objective is not the JAX package's to 1e-12")
    n, p, T, every = ER_1024
    big = pkg.ExperimentConfig(problem_type="logistic", topology="erdos_renyi", n_workers=n,
                               erdos_renyi_p=p, n_iterations=T, eval_every=every,
                               dtype="float32")
    bds, bf = _main_data(pkg, n)
    L = max(len(s) for s in bds.shard_indices)
    check(L <= big.local_batch_size, f"N={n}: shards of {L} rows, not the whole-shard path")
    for impl in ("auto", "gather", "sparse"):
        res, counted = _converging_run(torch, pkg, counters, big.replace(mixing_impl=impl), bds,
                                       bf, "topologies", converges=False)
        check(counted == _only(counted), f"ER N={n} {impl}: launches {counted}, not none")
        say(f"[topologies] ER N={n} p=12/{n} T={T} (L={L} <= b, whole shard) {impl}: "
            f"{res.history.iters_per_second:.1f} iters/s")


def phase_push_sum(torch, np, pkg, kernels):
    """Push-sum on the card. Directed ER at N=256 (p = 12/256) under 'auto'
    (the dense product), T=10,000, eval every 10: ε within 1% of the JAX
    package's count, bitwise its ``measure_timestamps=True`` run, Σ w within
    1e-5 N of the JAX package's (PUSH_SUM_MASS) and its drift from N within
    what the float32 weights' column sums allow (T times their largest
    excess over 1). The directed ring at the study's N=25 in
    float64 under stencil, dense and sparse: each card run against its CPU
    run, and the three against each other, to 1e-12. Push-sum on the
    undirected ring at N=256 (T=3,000), pallas and stencil: bitwise equal
    (the ring kernel is bitwise its twin), w exactly 1, ``ring_mix`` 2T
    times in the pallas run (num and w) and no fused step. Returns the
    pallas run's launches."""
    counters = [kernels[k] for k in ("rk", "fk", "bk", "sk")]
    ds, f_opt = _main_data(pkg, 256)
    fields, T, want = IRREGULAR_RUNS["push_sum_der256"]
    cfg = pkg.ExperimentConfig(problem_type="logistic", n_workers=256, n_iterations=T,
                               eval_every=IRREGULAR_EVAL_EVERY, dtype="float32", **fields)
    res, counted = _converging_run(torch, pkg, counters, cfg, ds, f_opt, "push_sum",
                                   return_state=True)
    h = res.history
    crossed = pkg.iterations_to_threshold(h.objective, 0.08, h.eval_iterations)
    w = res.final_state["w"]
    mass = float(w.sum())
    say(f"[push_sum] directed ER auto: iters-to-0.08 {crossed}, JAX package {want} "
        f"({(crossed - want) / want:+.2%}), floats {h.total_floats_transmitted:.6g}, "
        f"sum w {mass!r} (N={cfg.n_workers}, {mass / cfg.n_workers - 1:+.3e}), w in "
        f"[{float(w.min()):.4f}, {float(w.max()):.4f}]")
    _within_count("push_sum directed ER", crossed, want)
    topo = pkg.build_topology(cfg.topology, cfg.n_workers, erdos_renyi_p=cfg.erdos_renyi_p,
                              seed=cfg.resolved_topology_seed())
    excess = float(np.abs(topo.mixing_matrix.astype(np.float32).astype(np.float64).sum(0)
                          - 1.0).max())
    drift = mass / cfg.n_workers - 1.0
    say(f"[push_sum] sum w drift {drift:+.3e} of N, within T x the float32 weights' largest "
        f"column excess {T * excess:.3e}; JAX package's sum w {PUSH_SUM_MASS!r} "
        f"({(mass - PUSH_SUM_MASS) / cfg.n_workers:+.3e} of N apart)")
    check(abs(drift) <= T * excess + 1e-5, f"push_sum: sum w = {mass} drifted past the float32 "
                                           f"weights' own {T * excess:.3e}")
    check(abs(mass - PUSH_SUM_MASS) <= 1e-5 * cfg.n_workers,
          f"push_sum: sum w = {mass}, not the JAX package's {PUSH_SUM_MASS} within 1e-5 N")
    expect = _only(counted, sample_worker_batch_weights=T)
    check(counted == expect, f"push_sum directed ER: launches {counted}, not {expect}")
    _graph_equals_measured(torch, np, pkg, counters, cfg, ds, f_opt, "push_sum", res, counted)
    study = pkg.ExperimentConfig(problem_type="logistic", algorithm="push_sum",
                                 topology="directed_ring", dtype="float64", eval_every=10,
                                 n_iterations=IRREGULAR_REFERENCE_ITERATIONS)
    sds, sf = _main_data(pkg, study.n_workers)
    cards = {}
    for impl in ("stencil", "dense", "sparse"):
        run_cfg = study.replace(mixing_impl=impl)
        cards[impl] = pkg.run(run_cfg, sds, sf, device="cuda")
        _agree(f"push_sum directed ring N=25 T={study.n_iterations} float64 {impl}", cards[impl],
               pkg.run(run_cfg, sds, sf, device="cpu"), phase="push_sum")
    for impl in ("dense", "sparse"):
        _agree(f"push_sum directed ring {impl} vs stencil, both", cards[impl], cards["stencil"],
               phase="push_sum")
    ring = pkg.ExperimentConfig(problem_type="logistic", algorithm="push_sum", n_workers=256,
                                n_iterations=PUSH_SUM_RING_ITERATIONS, dtype="float32",
                                eval_every=IRREGULAR_EVAL_EVERY)
    T = ring.n_iterations
    runs, launches = {}, None
    for impl in ("pallas", "stencil"):
        run_cfg = ring.replace(mixing_impl=impl)
        runs[impl], counted = _converging_run(torch, pkg, counters, run_cfg, ds, f_opt,
                                              "push_sum", converges=False, return_state=True)
        expect = _only(counted, sample_worker_batch_weights=T,
                       **({"ring_mix": 2 * T} if impl == "pallas" else {}))
        check(counted == expect, f"push_sum ring {impl}: launches {counted}, not {expect}")
        check(bool(np.all(runs[impl].final_state["w"] == 1.0)),
              f"push_sum ring {impl}: w moved off 1 on the doubly stochastic ring")
        if impl == "pallas":
            launches = counted
            _graph_equals_measured(torch, np, pkg, counters, run_cfg, ds, f_opt, "push_sum",
                                   runs[impl], counted, converges=False)
    same = (np.array_equal(runs["pallas"].history.objective, runs["stencil"].history.objective)
            and np.array_equal(runs["pallas"].final_models, runs["stencil"].final_models))
    say(f"[push_sum] ring N=256 pallas vs stencil: gap history and final models "
        f"{'bitwise equal' if same else 'DIFFER'}, w exactly 1 in both; iters/s pallas "
        f"{runs['pallas'].history.iters_per_second:.1f}, stencil "
        f"{runs['stencil'].history.iters_per_second:.1f}")
    check(same, "push_sum ring: the pallas run is not bitwise the stencil run")
    return launches


def robust_er(torch, np, pkg, bk, rk):
    """Sign-flip on ER at N=64, p=0.1 (rows of 3 to 13 live slots of 13) on
    the main path's data: trimmed mean and median with b=1, fused and
    gather, T=2,000. The fused runs launch the fused step T times and are
    bitwise their ``measure_timestamps=True`` runs, the gather runs launch
    it never; each fused history within 1e-6 relative of its gather twin
    (the robust phase's tolerance). Float64 fused runs (T=200), card
    against CPU to 1e-12. Then robust_scale.json's crossover cell (k_max
    40): 'auto' resolves to gather, and it runs finite."""
    ds, f_opt = _main_data(pkg, 64)
    base = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="erdos_renyi",
                                n_workers=64, erdos_renyi_p=0.1, n_iterations=ER_ROBUST_ITERATIONS,
                                eval_every=50, dtype="float32", attack="sign_flip", n_byzantine=6,
                                attack_scale=5.0)
    topo = pkg.build_topology("erdos_renyi", 64, erdos_renyi_p=0.1,
                              seed=base.resolved_topology_seed())
    graph = (int(topo.degrees.max()), int(topo.degrees.min()))
    say(f"[robust] ER N=64 p=0.1: k_max {graph[0]}, degrees {graph[1]} to {graph[0]}")
    check(graph == ER_ROBUST_GRAPH, f"the robust ER graph is {graph}, not {ER_ROBUST_GRAPH}")
    T = base.n_iterations
    rows = {f"er_{rule}_{impl}": base.replace(aggregation=rule, robust_b=1, robust_impl=impl)
            for rule in ("trimmed_mean", "median") for impl in ("fused", "gather")}
    runs = _screened_runs(pkg, rows, ds, f_opt, [bk, rk], "robust")
    for name, (res, launches) in runs.items():
        steps = launches.get("make_fused_robust_dsgd_step", 0)
        fused = name.endswith("fused")
        check(steps == (T if fused else 0), f"robust {name}: fused step launched {steps} times")
        check(bool(np.all(np.isfinite(res.history.objective))), f"robust {name}: non-finite")
        if fused:
            _graph_equals_measured(torch, np, pkg, [bk, rk], rows[name], ds, f_opt, "robust", res,
                                   launches, converges=False)
    for rule in ("trimmed_mean", "median"):
        rel = _relative_gap_diff(np, runs[f"er_{rule}_fused"][0], runs[f"er_{rule}_gather"][0])
        say(f"[robust] ER {rule} fused vs gather: largest relative gap difference {rel:.3e}")
        check(rel <= 1e-6, f"ER {rule}: fused and gather histories differ beyond 1e-6 relative")
        run_cfg = rows[f"er_{rule}_fused"].replace(dtype="float64",
                                                   n_iterations=IRREGULAR_REFERENCE_ITERATIONS)
        _agree(f"ER N=64 T={run_cfg.n_iterations} float64 sign_flip {rule} fused",
               pkg.run(run_cfg, ds, f_opt, device="cuda"), pkg.run(run_cfg, ds, f_opt, device="cpu"),
               phase="robust")
    cross = pkg.ExperimentConfig(**ROBUST_CROSSOVER)
    ctopo = pkg.build_topology("erdos_renyi", cross.n_workers, erdos_renyi_p=cross.erdos_renyi_p,
                               seed=cross.resolved_topology_seed())
    impl = pkg.resolve_robust_impl(cross, ctopo)
    cds = pkg.generate_synthetic_dataset(cross)
    _, cf = pkg.compute_reference_optimum(cds, cross.reg_param)
    res, launches = _screened_runs(pkg, {"crossover_er64_p0.5": cross}, cds, cf, [bk, rk],
                                   "robust")["crossover_er64_p0.5"]
    say(f"[robust] robust_scale.json crossover cell: k_max {int(ctopo.degrees.max())}, auto "
        f"resolves to {impl}")
    check(impl == "gather" and not launches, f"crossover: {impl}, launches {launches}")
    check(bool(np.all(np.isfinite(res.history.objective))), "crossover: non-finite")


def compression_bound(name: str, n: int, d: int, k: int, itemsize: int):
    """(ms, 'bytes' or 'operations') for one exchange's estimate update: v
    and memory read once and memory⁺ written once, against the draws' N·d + 2
    Threefry calls (random_k, qsgd) and a top-k selection of d·⌈log2 k⌉
    compares a row (top_k, random_k) on the INT32 lanes."""
    threefry = (n * d + 2) * THREEFRY_OPS if name != "top_k" else 0
    select = n * d * max(1, math.ceil(math.log2(k))) if name != "qsgd" else 0
    t_bytes = 3 * n * d * itemsize / PEAK_BYTES_PER_S * 1e3
    t_ops = (threefry + select) / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compression_inputs(torch, n: int, d: int, dtype):
    """v and memory [N, d] from a seed, with a row of zero differences, a row
    whose middle magnitudes tie across every k of COMPRESSION_OPERATORS,
    −0.0 differences (v = −0.0 over memory = 0), a row of equal magnitudes
    of both signs and a zero memory row."""
    gen = torch.Generator(device="cuda").manual_seed(n * 7_919 + d)
    v = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
    memory = 0.5 * torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
    v[1] = memory[1]
    v[2] = memory[2] + 0.01 * torch.randn(d, generator=gen, device="cuda", dtype=dtype)
    v[2, : min(d, 40)] = memory[2, : min(d, 40)] + 0.75
    v[3, ::2], memory[3, ::2] = -0.0, 0.0
    v[4] = memory[4] + torch.where(torch.rand(d, generator=gen, device="cuda") < 0.5, -1.5, 1.5)
    memory[5] = 0.0
    return v.contiguous(), memory.contiguous()


def _bits(torch, x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _ulp(torch, x):
    """The spacing of the floats at |x|."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def _check_compression(torch, ck, comp, draw, v, memory, what):
    """The kernel against the twin at one input: top_k and random_k bitwise
    (memory⁺ and the mask); qsgd with no rounding decision differing and
    each element within 4 ulp of the row's ω‖v‖/s times its level (plus an
    ulp of memory⁺ for the add). Returns (largest difference, elements not
    bitwise equal, decisions differing)."""
    got = ck.ef_compress(comp, draw, v, memory)
    out, levels = ck.ef_levels(comp, draw, v, memory)
    want = ck.compression.ef_compress_plain(comp, draw, v, memory)
    want_levels = ck.levels_plain(comp, draw, v, memory)
    err = float((got - want).abs().max())
    off = int((_bits(torch, got) != _bits(torch, want)).sum())
    decisions = int((levels != want_levels).sum())
    check(torch.equal(_bits(torch, got), _bits(torch, out)),
          f"compression {what}: ef_compress and ef_levels differ")
    if comp.name != "qsgd":
        check(off == 0 and decisions == 0,
              f"compression {what}: {off} elements not bitwise, {decisions} mask bits differ")
    else:
        check(decisions == 0, f"compression {what}: {decisions} rounding decisions differ")
        norm = ck.compression.row_norm(v - memory)
        unit = float(comp.delta) * norm / 2.0**comp.k
        tol = 4 * want_levels.to(v.dtype) * _ulp(torch, unit) + _ulp(torch, want)
        check(bool(torch.all((got - want).abs() <= tol)),
              f"compression {what}: beyond 4 ulp of ω‖v‖/s ({err:.3e})")
    return err, off, decisions


def compression_kernel_checks(torch, np, ck, prng):
    """The compression kernel against its twin at every input of the grid,
    then the known answers. Returns the inputs checked."""
    compression = ck.compression
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    checked = qsgd_bitwise = qsgd_total = 0
    for n, d in COMPRESSION_SHAPES:
        for dname, seeds in COMPRESSION_SEEDS.items():
            dtype = getattr(torch, dname)
            v, memory = compression_inputs(torch, n, d, dtype)
            for name, k in COMPRESSION_OPERATORS:
                comp = compression.make_compressor(name, d, d if k is None else k)
                draws = [(seed, counter, rnd) for seed in seeds for counter in COMPRESSION_COUNTERS
                         for rnd in COMPRESSION_ROUNDS] if name != "top_k" else [(0, 0, 0)]
                for seed, counter, rnd in draws:
                    t.fill_(counter)
                    draw = compression.Draw(compression.tag_key(seed, x64=dtype == torch.float64),
                                            t, rnd)
                    what = (f"{name} k={comp.k} N={n} d={d} {dname} seed={seed} t={counter} "
                            f"round={rnd}")
                    _, off, _ = _check_compression(torch, ck, comp, draw, v, memory, what)
                    checked += 1
                    if name == "qsgd":
                        qsgd_total += 1
                        qsgd_bitwise += off == 0
    say(f"[compression] kernel vs twin at {checked} inputs ({len(COMPRESSION_SHAPES)} shapes, "
        f"both dtypes, {len(COMPRESSION_OPERATORS)} operators, seeds, t {COMPRESSION_COUNTERS}, "
        f"rounds {COMPRESSION_ROUNDS}; ties, zero rows, -0.0): top_k and random_k bitwise, qsgd "
        f"0 rounding decisions differing and within 4 ulp, bitwise at {qsgd_bitwise} of "
        f"{qsgd_total}")
    for (seed, counter, rnd, dname, n, d, k), want in COMPRESSION_KNOWN_ANSWERS.items():
        dtype = getattr(torch, dname)
        t.fill_(counter)
        draw = compression.Draw(compression.tag_key(seed, x64=dtype == torch.float64), t, rnd)
        ones = torch.ones((n, d), dtype=dtype, device="cuda")
        _, mask = ck.ef_levels(compression.make_compressor("random_k", d, k), draw, ones,
                               torch.zeros_like(ones))
        u = prng.uniform(draw.key(), (n, d), dtype)
        got = (_digest(np, mask.cpu().numpy()), _digest(np, u.cpu().numpy()))
        say(f"[compression] known answer seed={seed} t={counter} round={rnd} {dname} N={n} d={d} "
            f"k={k}: random_k mask (kernel), qsgd uniforms {' '.join(got)} "
            f"({'equal to' if got == want else 'NOT'} jax 0.9.0's)")
        check(got == want, f"compression known answer {seed, counter, rnd, dname}: {got} != {want}")
        v, memory = compression_inputs(torch, n, d, dtype)
        _check_compression(torch, ck, compression.make_compressor("qsgd", d, 4), draw, v, memory,
                           f"qsgd at the known answer {seed, counter, rnd, dname}")
    return checked


def compression_records(torch, ck, prng):
    """Times at the main shape in float32: each operator of the runs in a
    graph of 200 and event-timed, its twin and its bound, and torch.topk of
    its scores in a graph (the selection alone). Returns the record of
    COMPRESSION_RECORD."""
    compression = ck.compression
    n, d = MAIN_SHAPE
    dtype = torch.float32
    v, memory = compression_inputs(torch, n, d, dtype)
    t = torch.full((1,), 12_345, dtype=torch.int64, device="cuda")
    draw = compression.Draw(compression.tag_key(203, x64=False), t, 0)
    record = None
    for name, k in COMPRESSION_TIMED:
        comp = compression.make_compressor(name, d, k)
        kernel = lambda: ck.ef_compress(comp, draw, v, memory)  # noqa: E731
        plain = lambda: compression.ef_compress_plain(comp, draw, v, memory)  # noqa: E731
        err, _, _ = _check_compression(torch, ck, comp, draw, v, memory, f"{name} timed input")
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        b_ms, b_by = compression_bound(name, n, d, k, dtype.itemsize)
        label = f"compress_exchange[{name} k={k}]"
        _kernel_line(label, f"N={n} d={d}", "float32", err, ms, plain_ms, None, b_ms, b_by)
        in_graph = _in_graph(torch, label, kernel, ms, b_ms)
        if name != "qsgd":
            diff = v - memory
            scores = diff.abs() if name == "top_k" else prng.uniform(draw.key(), v.shape, v.dtype)
            topk_ms = graph_ms(torch, lambda: torch.topk(scores, k, dim=-1))
            say(f"[compression] yardstick torch.topk(scores [{n}, {d}], {k}) float32 in a graph of "
                f"{TIMED_LAUNCHES}: {topk_ms * 1e3:.3f} us a call (selection only, not the "
                f"function)")
        if (name, k) == COMPRESSION_RECORD:
            record = _record("compress_exchange", err, ms, plain_ms, b_ms, b_by, None,
                             graph_ms=in_graph, topk_graph_ms=topk_ms)
    for (n, d), dtype, (name, k) in itertools.product(
            COMPRESSION_WIDE_TIMED, (torch.float32, torch.float64), COMPRESSION_TIMED):
        dname = str(dtype).removeprefix("torch.")
        v, memory = compression_inputs(torch, n, d, dtype)
        draw = compression.Draw(compression.tag_key(203, x64=dtype == torch.float64), t, 0)
        comp = compression.make_compressor(name, d, k)
        kernel = lambda: ck.ef_compress(comp, draw, v, memory)  # noqa: E731
        ms, in_graph = time_ms(torch, kernel), graph_ms(torch, kernel)
        b_ms, b_by = compression_bound(name, n, d, k, dtype.itemsize)
        say(f"[compression] wide compress_exchange[{name} k={k}] N={n} d={d} {dname}: in a graph of "
            f"{TIMED_LAUNCHES} {in_graph * 1e3:.3f} us, event-timed {ms * 1e3:.3f} us, bound "
            f"{b_ms * 1e3:.4f} us ({b_by})")
    return record


def _agree_close(np, phase, label, card, host, tol=1e-12):
    """Card against CPU: gap and consensus histories, final models and every
    estimate leaf fetched to ``tol`` (rtol and atol)."""
    pairs = [("gap", card.history.objective, host.history.objective)]
    if host.history.consensus_error is not None:
        pairs.append(("consensus", card.history.consensus_error, host.history.consensus_error))
    pairs.append(("models", card.final_models, host.final_models))
    if host.final_state is not None:
        pairs += [(leaf, card.final_state[leaf], host.final_state[leaf])
                  for leaf in ("xhat", "yhat") if leaf in host.final_state]
    worst = {what: float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) for what, a, b in pairs}
    say(f"[{phase}] {label} on the card vs plain on the CPU: "
        + ", ".join(f"{what} {err:.3e}" for what, err in worst.items()))
    check(all(np.allclose(a, b, rtol=tol, atol=tol) for _, a, b in pairs),
          f"{label}: card and CPU runs disagree beyond {tol}")



def phase_compression(torch, np, pkg, kernels, prng):
    """The compression kernel against its twin and JAX's known answers; its
    times at the main shape; the COMPRESSION_RUNS on the main path's data,
    pallas and stencil, gated on iterations to ε within 1% of the JAX count,
    floats transmitted exactly JAX's, exact launch counts and (pallas)
    bitwise their measure_timestamps=True runs, with constant-step D-SGD
    bitwise CHOCO; beside them the uncompressed D-SGD and GT pallas runs of
    the same T; then float64 runs on the card against the CPU. Returns (the
    kernel's record, the launches of choco_randk27's pallas run)."""
    ck = kernels["ck"]
    counters = [kernels["rk"], kernels["fk"], kernels["bk"], kernels["sk"], ck]
    compression_kernel_checks(torch, np, ck, prng)
    record = compression_records(torch, ck, prng)
    base = pkg.ExperimentConfig(problem_type="logistic", topology="ring", n_workers=256,
                                dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param)
    record_launches = None
    results = {}
    for name, (fields, T, want, floats) in COMPRESSION_RUNS.items():
        cfg = base.replace(n_iterations=T, **fields)
        rounds = 2 if fields["algorithm"] == "gradient_tracking" else 1
        for impl in ("pallas", "stencil"):
            run_cfg = cfg.replace(mixing_impl=impl)
            res, counted = _converging_run(torch, pkg, counters, run_cfg, ds, f_opt, "compression")
            h = res.history
            crossed = pkg.iterations_to_threshold(h.objective, 0.08, h.eval_iterations)
            say(f"[compression] {name} {impl}: iters-to-0.08 {crossed}, JAX package {want} "
                f"({(crossed - want) / want:+.2%}), floats {h.total_floats_transmitted:.6g} "
                f"(JAX {floats:.6g}), {h.iters_per_second:.1f} iters/s")
            _within_count(f"compression {name} {impl}", crossed, want)
            check(h.total_floats_transmitted == floats,
                  f"compression {name}: floats {h.total_floats_transmitted} != JAX {floats}")
            expect = {key: 0 for key in counted}
            expect["sample_worker_batch_weights"] = T
            expect["compress_exchange"] = rounds * T
            if impl == "pallas":
                expect["ring_mix"] = rounds * T
            check(counted == expect, f"compression {name} {impl}: launches {counted}, not {expect}")
            if impl == "pallas":
                _graph_equals_measured(torch, np, pkg, counters, run_cfg, ds, f_opt,
                                       "compression", res, counted)
                results[name] = res
                if name == "choco_randk27":
                    record_launches = counted
    a, b = results["dsgd_randk27_const"], results["choco_randk27"]
    same = (np.array_equal(a.history.objective, b.history.objective)
            and np.array_equal(a.final_models, b.final_models))
    say(f"[compression] dsgd_randk27_const vs choco_randk27 (pallas): gap digests "
        f"{_digest(np, a.history.objective)} {_digest(np, b.history.objective)}, final models "
        f"{'bitwise equal' if same else 'DIFFER'}")
    check(same, "constant-step compressed dsgd is not bitwise choco")
    for algorithm in ("dsgd", "gradient_tracking"):
        cfg = base.replace(n_iterations=3_000, mixing_impl="pallas", algorithm=algorithm)
        h = pkg.run(cfg, ds, f_opt, device="cuda").history
        say(f"[compression] uncompressed {algorithm} pallas N=256 T=3000, same call: "
            f"{h.iters_per_second:.1f} iters/s (graph), final gap {h.objective[-1]:.6f}")
    small = pkg.ExperimentConfig(
        problem_type="logistic", n_workers=8, n_samples=400, n_features=10,
        n_informative_features=6, n_iterations=200, local_batch_size=8, mixing_impl="pallas",
        sampling_impl="dense", dtype="float64",
    )
    sds = pkg.generate_synthetic_dataset(small)
    _, sf = pkg.compute_reference_optimum(sds, small.reg_param)
    for topology in ("ring", "fully_connected"):
        for fields in COMPRESSION_REFERENCE:
            cfg = small.replace(topology=topology, **fields)
            for c in counters:
                c.reset_launch_counts()
            card = pkg.run(cfg, sds, sf, device="cuda", return_state=True)
            mix = "ring_mix" if topology == "ring" else "fc_mix"
            rounds = 2 if fields["algorithm"] == "gradient_tracking" else 1
            launched = {k: v for c in counters for k, v in c.LAUNCHES.items()}
            check(launched["compress_exchange"] == launched[mix] == rounds * cfg.n_iterations,
                  f"compression float64 {topology} {fields}: launches {launched}")
            label = (f"N=8 T=200 float64 {topology} pallas {fields['algorithm']} "
                     f"{fields['compression']} k={fields['compression_k']}")
            _agree_close(np, "compression", label, card,
                         pkg.run(cfg, sds, sf, device="cpu", return_state=True))
    return record, record_launches


def phase_study(torch, np, pkg):
    """The eight rows of ``examples/reproduce_report.py`` at its config
    defaults (the port's ``ExperimentConfig`` defaults: N=25, T=10,000,
    b=16, η₀=0.05/√(t+1), λ=1e-4, sorted, ε=0.08, float32, mixing 'auto'),
    one dataset and optimum per problem. Gates: each row crosses ε within T
    and within 1% of the JAX package's count for the same row, its floats
    transmitted are exactly the published count, and the run leaves the
    card's allocated memory as it found it."""
    data = {}
    for (problem, label), (algorithm, topology, published, jax_iters, floats) in \
            STUDY_ROWS.items():
        cfg = pkg.ExperimentConfig(problem_type=problem, algorithm=algorithm, topology=topology)
        if problem not in data:
            ds = pkg.generate_synthetic_dataset(cfg)
            data[problem] = (ds, pkg.compute_reference_optimum(ds, cfg.reg_param)[1])
        ds, f_opt = data[problem]
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        res = pkg.run(cfg, ds, f_opt, device="cuda")
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - allocated
        h = res.history
        crossed = pkg.iterations_to_threshold(h.objective, cfg.suboptimality_threshold,
                                              h.eval_iterations)
        say(f"[study] {problem:9s} {label:24s} iters-to-{cfg.suboptimality_threshold} "
            f"{crossed:6d}  JAX package {jax_iters:6d} ({(crossed - jax_iters) / jax_iters:+.2%})"
            f"  published {published:6d} (port {(crossed - published) / published:+.2%}, JAX "
            f"package {(jax_iters - published) / published:+.2%})  "
            f"floats {h.total_floats_transmitted:.4g}  {h.iters_per_second:.1f} iters/s "
            f"(warm-up and capture {h.compile_seconds:.2f} s), final gap {h.objective[-1]:.6f}, "
            f"gap history sha256 {_digest(np, h.objective)}")
        check(h.total_floats_transmitted == floats,
              f"study {problem} {label}: {h.total_floats_transmitted} floats, not {floats}")
        check(bool(np.all(np.isfinite(h.objective))), f"study {problem} {label}: non-finite gaps")
        check(0 < crossed <= cfg.n_iterations,
              f"study {problem} {label}: never reached ε within T={cfg.n_iterations}")
        check(left == 0, f"study {problem} {label}: the run left {left} bytes allocated")
        check(abs(crossed - jax_iters) <= COUNT_TOLERANCE * jax_iters,
              f"study {problem} {label}: {crossed} iterations, not within "
              f"{COUNT_TOLERANCE:.0%} of the JAX package's {jax_iters}")


def _screened_runs(pkg, rows, ds, f_opt, counters, label):
    """Run each named config; returns {name: (result, launches)}."""
    import numpy as np

    out = {}
    for name, cfg in rows.items():
        for c in counters:
            c.reset_launch_counts()
        t0 = time.perf_counter()
        res = pkg.run(cfg, ds, f_opt, device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items() if v}
        h = res.history
        gap = float(h.objective[-1])
        say(f"[{label}] {name:24s} final honest gap {gap:.6f} "
            f"({'diverged' if not np.isfinite(gap) else 'finite'}), honest consensus "
            f"{float(h.consensus_error[-1]):.3e}, {h.iters_per_second:.1f} iters/s "
            f"(warm-up and capture {h.compile_seconds:.2f} s, whole run {wall:.2f} s), "
            f"launches {launches}, gap history sha256 {_digest(np, h.objective)}")
        out[name] = (res, launches)
    return out


def _breakdown_gates(np, runs, screened, label):
    clean = float(runs["attack_free"][0].history.objective[-1])
    plain = float(runs["signflip_plain"][0].history.objective[-1])
    check(not np.isfinite(plain) or plain >= 10.0 * clean,
          f"{label}: plain gossip under sign-flip neither diverged nor stalled 10x above "
          f"attack-free ({plain} vs {clean})")
    for name in screened:
        gaps = runs[name][0].history.objective
        check(bool(np.all(np.isfinite(gaps))) and gaps[-1] <= 2.0 * clean,
              f"{label}: {name} ended at {gaps[-1]}, not finite within 2x of attack-free {clean}")
    return clean


def phase_byzantine(np, pkg, bk, dk):
    base = pkg.ExperimentConfig(
        problem_type="logistic", algorithm="dsgd", topology="ring", n_workers=64,
        n_samples=6400, n_features=10, n_informative_features=6, n_iterations=4000,
        local_batch_size=100, eval_every=500, partition="shuffled", dtype="float32",
    )
    attack = dict(attack="sign_flip", n_byzantine=6, attack_scale=5.0)
    robust = dict(robust_b=1, robust_impl="fused")
    rows = {
        "attack_free": base,
        "signflip_plain": base.replace(**attack),
        "signflip_tm": base.replace(**attack, aggregation="trimmed_mean", **robust),
        "signflip_median": base.replace(**attack, aggregation="median", **robust),
        "signflip_clip": base.replace(**attack, aggregation="clipped_gossip", **robust),
        "alie_tm": base.replace(attack="alie", n_byzantine=6, attack_scale=1.0,
                                aggregation="trimmed_mean", **robust),
        "noise_plain": base.replace(attack="large_noise", n_byzantine=6, attack_scale=10.0),
        "noise_tm": base.replace(attack="large_noise", n_byzantine=6, attack_scale=10.0,
                                 aggregation="trimmed_mean", **robust),
    }
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param)
    runs = _screened_runs(pkg, rows, ds, f_opt, [bk, dk], "byzantine")
    T = base.n_iterations
    for name, (res, launches) in runs.items():
        check(launches.get("large_noise", 0) == (T if name.startswith("noise") else 0),
              f"byzantine {name}: large_noise launched {launches}")
        if name in ("attack_free", "signflip_plain", "noise_plain"):
            continue
        check(launches.get("make_fused_robust_dsgd_step") == T,
              f"byzantine {name}: fused robust step launched {launches}, not T")
    _breakdown_gates(np, runs, ("signflip_tm", "signflip_median", "signflip_clip", "alie_tm"),
                     "byzantine")
    for name, want in BYZANTINE_REFERENCE.items():
        got = float(runs[name][0].history.objective[-1])
        say(f"[byzantine] {name:16s} port {got:.6f}  JAX package {want:.6f}  "
            f"({(got - want) / want:+.3%})")
        check(abs(got - want) <= 0.01 * want, f"byzantine {name}: {got} not within 1% of {want}")
    say("[byzantine] signflip_plain: port "
        f"{runs['signflip_plain'][0].history.objective[-1]}, JAX package diverged (NaN)")
    for name, want in NOISE_REFERENCE.items():
        got = float(runs[name][0].history.objective[-1])
        say(f"[byzantine] {name:16s} port {got:.6f}  JAX package on a CPU {want:.6f} "
            f"({(got - want) / want:+.3%}); docs/perf/byzantine.json {NOISE_JSON[name]:.6f} "
            f"({(got - NOISE_JSON[name]) / NOISE_JSON[name]:+.3%})")
        check(abs(got - want) <= 0.01 * want, f"byzantine {name}: {got} not within 1% of {want}")
    got = float(runs["noise_tm"][0].history.objective[-1])
    check(abs(got - NOISE_JSON["noise_tm"]) <= 0.01 * NOISE_JSON["noise_tm"],
          f"byzantine noise_tm: {got} not within 1% of docs/perf/byzantine.json")
    return runs["noise_plain"][1]


# The robust phase's faulted cell: the edge drop rate.
ROBUST_EDGE_DROP = 0.1


def robust_config(pkg, T: int = 5000):
    return pkg.ExperimentConfig(
        problem_type="logistic", algorithm="dsgd", topology="ring", n_workers=256,
        n_samples=12_800, n_features=40, n_informative_features=20, n_iterations=T,
        local_batch_size=16, eval_every=50, partition="shuffled", dtype="float32",
        mixing_impl="pallas",
    )


def phase_robust(np, pkg, bk, rk, dk):
    base = robust_config(pkg)
    T = base.n_iterations
    attack = dict(attack="sign_flip", n_byzantine=12, attack_scale=5.0)
    rows = {"attack_free": base, "signflip_plain": base.replace(**attack)}
    for rule in ("trimmed_mean", "median", "clipped_gossip"):
        rows[f"signflip_{rule}"] = base.replace(**attack, aggregation=rule, robust_b=1,
                                                robust_impl="fused")
    rows["signflip_trimmed_mean_gather"] = rows["signflip_trimmed_mean"].replace(
        robust_impl="gather")
    # The same screens over a graph that drops 10% of its edges each round:
    # the fused kernels read a liveness gathered from the round's A_t.
    for rule in ("trimmed_mean", "median"):
        for impl in ("fused", "gather"):
            rows[f"edges10_{rule}_{impl}"] = base.replace(
                **attack, aggregation=rule, robust_b=1, robust_impl=impl,
                edge_drop_prob=ROBUST_EDGE_DROP)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param)
    runs = _screened_runs(pkg, rows, ds, f_opt, [bk, rk, dk], "robust")
    for name, (res, launches) in runs.items():
        steps = launches.get("make_fused_robust_dsgd_step", 0)
        want = T if (name.startswith("signflip_") and name[9:] in (
            "trimmed_mean", "median", "clipped_gossip")) or name.endswith("_fused") else 0
        check(steps == want, f"robust {name}: fused robust step launched {steps} times, "
                             f"not {want}")
        draws = launches.get("realize_round", 0)
        check(draws == (T if name.startswith("edges10_") else 0),
              f"robust {name}: realize_round launched {draws} times")
    _breakdown_gates(np, runs, [n for n in rows if n.startswith("signflip_") and
                                n != "signflip_plain"], "robust")
    for rule in ("trimmed_mean", "median"):
        fused = runs[f"edges10_{rule}_fused"][0].history.objective
        gather = runs[f"edges10_{rule}_gather"][0].history.objective
        check(bool(np.all(np.isfinite(fused))), f"robust edges10 {rule}: non-finite gaps")
        rel = float(np.max(np.abs(gather - fused) / np.abs(fused)))
        say(f"[robust] {rule} under 10% edge drops, fused vs gather: largest relative gap "
            f"difference {rel:.3e}; iters/s fused "
            f"{runs[f'edges10_{rule}_fused'][0].history.iters_per_second:.1f}, gather "
            f"{runs[f'edges10_{rule}_gather'][0].history.iters_per_second:.1f}")
        check(rel <= 1e-6, f"robust edges10 {rule}: fused and gather differ beyond 1e-6")
    # Gradient tracking there: the aggregator kernel twice a round, on the
    # round's liveness.
    gt = base.replace(**attack, algorithm="gradient_tracking", aggregation="trimmed_mean",
                      robust_b=1, edge_drop_prob=ROBUST_EDGE_DROP,
                      n_iterations=TRACKING_ROBUST_ITERATIONS)
    gt_runs = _screened_runs(pkg, {"edges10_gt_trimmed_mean_fused": gt.replace(
        robust_impl="fused"), "edges10_gt_trimmed_mean_gather": gt.replace(
        robust_impl="gather")}, ds, f_opt, [bk, rk, dk], "robust")
    T_gt = gt.n_iterations
    fused, launches = gt_runs["edges10_gt_trimmed_mean_fused"]
    check(launches.get("make_fused_robust_aggregator") == 2 * T_gt
          and launches.get("realize_round") == T_gt,
          f"robust edges10 GT: launches {launches}, not the aggregator 2T and one realization T")
    gather = gt_runs["edges10_gt_trimmed_mean_gather"][0].history.objective
    rel = float(np.max(np.abs(gather - fused.history.objective) / np.abs(fused.history.objective)))
    say(f"[robust] GT trimmed_mean under 10% edge drops, fused vs gather: largest relative gap "
        f"difference {rel:.3e}")
    check(bool(np.all(np.isfinite(gather))) and rel <= 1e-6,
          f"robust edges10 GT: fused and gather differ beyond 1e-6 ({rel})")
    fused = runs["signflip_trimmed_mean"][0].history.objective
    gather = runs["signflip_trimmed_mean_gather"][0].history.objective
    rel = float(np.max(np.abs(gather - fused) / np.abs(fused)))
    say(f"[robust] trimmed_mean fused vs gather: largest relative gap difference {rel:.3e}")
    check(rel <= 1e-6, "fused and gather trimmed-mean histories differ beyond 1e-6 relative")
    for name, want in ROBUST_REFERENCE.items():
        say(f"[robust] {name:24s} port {float(runs[name][0].history.objective[-1]):.6f}  "
            f"JAX package on a CPU {want:.5f}")
    ips_f = runs["signflip_trimmed_mean"][0].history.iters_per_second
    ips_g = runs["signflip_trimmed_mean_gather"][0].history.iters_per_second
    say(f"[robust] trimmed_mean iters/s: fused {ips_f:.1f}, gather {ips_g:.1f} "
        f"({ips_f / ips_g:.3f}x)")
    return runs["signflip_trimmed_mean"][0].final_models, runs["edges10_trimmed_mean_fused"][1]


def phase_robust_mixing(torch, np, pkg, kernels, final_models):
    from distributed_optimization_tpu_torch.ops.robust_aggregation import robust_aggregate_np

    bk, fk, rk = kernels["bk"], kernels["fk"], kernels["rk"]
    base = robust_config(pkg).replace(attack="sign_flip", n_byzantine=12, attack_scale=5.0)
    n = base.n_workers
    topo = pkg.build_topology("ring", n)
    algo = pkg.get_algorithm("dsgd")
    dev = torch.device("cuda")
    x = torch.as_tensor(final_models, dtype=torch.float32, device=dev).contiguous()
    scale = float(x.abs().max())
    for c in (bk, fk, rk):
        c.reset_launch_counts()
    for rule in ("trimmed_mean", "median", "clipped_gossip"):
        out = {}
        for impl in ("fused", "gather"):
            cfg = base.replace(aggregation=rule, robust_b=1, robust_impl=impl)
            op = pkg.make_mixing_op(topo, "pallas")
            byz = pkg.bind_byzantine(cfg, algo, topo, op, device=dev, dtype=torch.float32)
            out[impl] = byz.at(None, None)[0](x)
        torch.cuda.synchronize()
        err = float((out["fused"] - out["gather"]).abs().max())
        if rule in ("trimmed_mean", "median"):
            check(_nan_equal(torch, out["fused"], out["gather"]),
                  f"robust_mixing {rule}: fused and gather Byzantine mixes differ ({err:.3e})")
        else:
            check(err <= 1e-5 * scale, f"robust_mixing {rule}: fused vs gather {err:.3e}")
        corrupted = byz.adversary.corrupt(x).double().cpu().numpy()
        want = robust_aggregate_np(rule, topo.adjacency, corrupted, cfg.robust_b)
        byz_rows = byz.adversary.byzantine
        want[byz_rows] = (topo.mixing_matrix @ x.double().cpu().numpy())[byz_rows]
        oracle = float(np.abs(out["fused"].double().cpu().numpy() - want).max())
        say(f"[robust_mixing] {rule:14s} byz_mix fused vs gather {err:.3e}, vs numpy oracle "
            f"{oracle:.3e} (max |x| {scale:.3e})")
        check(oracle <= 1e-5 * scale, f"robust_mixing {rule}: {oracle:.3e} from the oracle")
    fc = pkg.build_topology("fully_connected", n)
    op = pkg.make_mixing_op(fc, "pallas")
    mixed, summed = op.apply(x), op.neighbor_sum(x)
    torch.cuda.synchronize()
    x64 = x.double().cpu().numpy()
    err_w = float(np.abs(mixed.double().cpu().numpy() - fc.mixing_matrix @ x64).max())
    err_a = float(np.abs(summed.double().cpu().numpy() - fc.adjacency @ x64).max())
    eps = float(np.finfo(np.float32).eps)
    # float32 rounding of a column's N-term sum: N·eps·Σ|x| for A x, whose
    # entries reach Σ|x|; the mean W x is that over N, at most N·eps·max|x|.
    tol = n * eps * scale
    tol_a = n * eps * float(np.abs(x64).sum(axis=0).max())
    mirror = fk.MIRRORS["fc_neighbor_sum"](x, fk.plan_for("fc_neighbor_sum", x))
    say(f"[robust_mixing] MixingOp(pallas) fully_connected N={n}: |Wx - dense| {err_w:.3e} "
        f"(N·eps·max|x| {tol:.3e}), |Ax - dense| {err_a:.3e} (N·eps·max Σ|x| {tol_a:.3e}), "
        f"Ax {'bitwise equal to' if torch.equal(summed, mirror) else 'NOT'} the mirror of its "
        f"summation order")
    check(err_w <= tol and err_a <= tol_a, "MixingOp(pallas) on fully_connected disagrees")
    check(torch.equal(summed, mirror), "fc_neighbor_sum is not bitwise the mirror of its order")
    launches = {k: v for c in (bk, fk, rk) for k, v in c.LAUNCHES.items()}
    say(f"[robust_mixing] launches {launches}")
    return launches


def realize_bound(tables, itemsize: int):
    """(ms, 'bytes' or 'operations') for one round: t and the neighbour
    tables read once; A_t [N, N] float32, W_t [N, N] (``itemsize`` bytes an
    entry), active [N] and the degree total (read and written) once; one
    Threefry call and a compare a base edge and a node, one a round key."""
    n = tables.n
    table_bytes = sum(x.numel() * x.element_size() for x in (
        tables.in_nbr, tables.in_cnt, tables.out_nbr, tables.out_cnt) if x is not None)
    edges = int(tables.in_cnt.sum()) // (1 if tables.directed else 2)
    nbytes = 8 + table_bytes + (4 + itemsize) * n * n + 4 * n + 16
    draws = edges + n + 3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (THREEFRY_OPS + 1) * draws / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _round_is_the_twin_s(torch, dk, fm, t, dtype, graph, n, mode) -> int:
    """One round of ``fm`` (a card's FaultyMixing) at t through the kernel
    against its plain version on the same card tensors: A_t, active, W_t,
    the scores and the degree count bit for bit."""
    tt = torch.tensor([t], device="cuda")
    kw = dict(drop_prob=fm.drop_prob, straggler_prob=fm.straggler_prob, timeline=fm._tl,
              weights=None if fm.one_peer else dtype, scores=fm.one_peer)
    want_total = torch.full((), 5.0, dtype=torch.float64, device="cuda")
    want = dk.realize_round_plain(tt, fm._keys, fm._tables, degree_total=want_total, **kw)
    total = torch.full((), 5.0, dtype=torch.float64, device="cuda")
    got = dk.realize_round(tt, fm._keys, fm._tables, degree_total=total, **kw)
    same = all((a is None) == (b is None) and (a is None or torch.equal(a, b))
               for a, b in zip(got, want)) and torch.equal(total, want_total)
    check(same, f"realize_round {graph} N={n} {mode} {dtype} t={t}: not bitwise its plain "
                "version")


def timeline_bound(horizon: int, edges: int, nodes: int, part: int, streams: int,
                   edge_list: bool = True):
    """The timeline: the [E, 2] int32 edge list read once (none on the
    per-edge stream), one byte an (iteration, edge or node) written
    (node_up and rejoin for the chain); each iteration a round key a stream
    and one Threefry call and compare an entity."""
    nbytes = 8 * edges * edge_list + horizon * (edges + 2 * nodes + part)
    ops = horizon * ((THREEFRY_OPS + 2) * (edges + nodes + part) + THREEFRY_OPS * streams)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slot_round_bound(tables, row_bytes: int, itemsize: int, live_slots: int):
    """(ms, 'bytes' or 'operations') for one slot round: t and the counts
    read once, the neighbour and edge-id entries of the real slots only
    (cnt's sum: neither table is read at a padded slot), the timeline's row
    (``row_bytes``) once; live [N, k] float32, w [N, k] and w_self [N] in
    ``itemsize`` bytes, active [N] and the degree total (read and written)
    written once; a max, an add and a divide a live slot (``live_slots``,
    this round's)."""
    n, k = tables.nbr.shape
    real = int(tables.cnt.sum())
    nbytes = 8 + 4 * real * (1 + (tables.eid is not None)) + 4 * n + row_bytes
    nbytes += (4 + itemsize) * n * k + (4 + itemsize) * n + 16
    return _bound(nbytes, 3 * live_slots, "float32" if itemsize == 4 else "float64")


def noise_bound(n: int, d: int, n_byz: int, dtype_name: str, itemsize: int):
    """The payload: x read and the output written once, the [N] mask; on the
    Byzantine rows a Threefry call (two words in float64 from one call) and
    an erf_inv an element, plus the scale's multiply and add."""
    nbytes = 2 * n * d * itemsize + n + 8
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (THREEFRY_OPS * n_byz * d / PEAK_INT32_OPS
             + (ERF_INV_OPS[dtype_name] + 4) * n_byz * d / PEAK_FLOPS[dtype_name]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timeline_kw(kw):
    """``faults.timeline_args``'s processes: ``kw`` over all off."""
    return dict(dict(edge_drop_prob=0.0, burst_len=1.0, straggler_prob=0.0, mttf=0.0, mttr=0.0,
                     participation_rate=1.0), **kw)


def _timeline_is_the_twin_s(torch, dk, args, horizon, dev, what) -> float:
    """``fault_timeline`` on the card against its plain version on the same
    card tensors, every output bit for bit. Returns the plain version's
    time, ms, of that one call (CUDA events, after the kernel's call has
    finished)."""
    got = dk.fault_timeline(horizon=horizon, device=dev, **args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = dk.fault_timeline_plain(horizon=horizon, device=dev, **args)
    end.record()
    torch.cuda.synchronize()
    for field, a in got.items():
        b = want[field]
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f"fault_timeline {what} {field}: not bitwise its plain version")
    return start.elapsed_time(end)


def draw_kernel_records(torch, np, dk, kernels_bk, pkg):
    """The three draw kernels against their plain versions on the card,
    bitwise, at their path inputs and beside them, with their times; and
    the fused robust aggregator (``kernels_bk``) on a round's liveness."""
    from distributed_optimization_tpu_torch.parallel import faults

    dev = torch.device("cuda")
    records = {}
    checked = 0
    for graph, n in ROUND_GRAPHS:
        topo = pkg.build_topology(graph, n, erdos_renyi_p=ROUND_DEGREE / n, seed=1)
        for mode, kw in ROUND_MODES.items():
            if topo.directed and mode == "one_peer":
                continue
            for dtype in (torch.float32, torch.float64):
                fm = faults.make_faulty_mixing(topo, seed=203, device=dev,
                                               x64=dtype == torch.float64, **kw)
                ts = (0, 17, ROUND_HORIZON - 1, ROUND_HORIZON, ROUND_HORIZON + 40) \
                    if fm.timeline is not None else (0, 17, 2**31 - 1, 2**32 + 9)
                for t in ts:
                    _round_is_the_twin_s(torch, dk, fm, t, dtype, graph, n, mode)
                    checked += 1
    say(f"[faults] realize_round bitwise its plain version (A_t, active, W_t, the degree "
        f"count, one-peer scores) at {checked} inputs: "
        f"{', '.join(f'{g} N={n}' for g, n in ROUND_GRAPHS)}; modes {', '.join(ROUND_MODES)}; "
        "W_t in float32 and float64")
    # The path's record: main's shapes under 20% drops and 10% stragglers.
    topo = pkg.build_topology("ring", 256)
    fm = faults.make_faulty_mixing(topo, 0.2, 203, straggler_prob=0.1, device=dev)
    tt = torch.tensor([123], device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    kw = dict(drop_prob=0.2, straggler_prob=0.1, weights=torch.float32, degree_total=total)
    ms = time_ms(torch, lambda: dk.realize_round(tt, fm._keys, fm._tables, **kw))
    in_graph = graph_ms(torch, lambda: dk.realize_round(tt, fm._keys, fm._tables, **kw))
    plain = time_ms(torch, lambda: dk.realize_round_plain(tt, fm._keys, fm._tables, **kw),
                    n=20)
    b_ms, b_by = realize_bound(fm._tables, 4)
    _kernel_line("realize_round", (256, 256), "float32", 0.0, ms, plain, None, b_ms, b_by,
                 f", in a graph {in_graph * 1e3:.3f} us (A_t, W_t, active, degree count)")
    records["realize_round"] = _record("realize_round", 0.0, ms, plain, b_ms, b_by, None,
                                       graph_ms=in_graph, shape=[256, 256], dtype="float32")
    # The fused robust aggregator on a round's liveness: the robust cell's
    # ring (N=256, d=41) under 10% drops, trimmed mean b=1, as GT's two
    # screens a step run it.
    from distributed_optimization_tpu_torch.parallel.topology import neighbor_tables_for

    topo = pkg.build_topology("ring", ROBUST_SHAPE[0])
    fm = faults.make_faulty_mixing(topo, ROBUST_EDGE_DROP, 203, device=dev)
    nbr_np, mask_np = neighbor_tables_for(topo)
    nbr64 = torch.as_tensor(nbr_np, dtype=torch.int64, device=dev)
    live = fm.realize(tt).live(nbr64, torch.as_tensor(mask_np, dtype=torch.float32, device=dev))
    x = torch.randn(ROBUST_SHAPE, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    agg = kernels_bk.make_fused_robust_aggregator("trimmed_mean", 1, nbr_np, device=dev)
    tau = torch.zeros(1, device=dev)
    got = agg(live, x)
    want = kernels_bk.fused_robust_plain("trimmed_mean", 1, nbr64, live, x, tau, adaptive=False)
    check(torch.equal(got, want), "fused robust aggregator on a round's liveness: not bitwise "
                                  "its plain version")
    ms = time_ms(torch, lambda: agg(live, x))
    in_graph = graph_ms(torch, lambda: agg(live, x))
    plain = time_ms(torch, lambda: kernels_bk.fused_robust_plain(
        "trimmed_mean", 1, nbr64, live, x, tau, adaptive=False), n=20)
    b_ms, b_by = robust_bound("trimmed_mean", *ROBUST_SHAPE, nbr_np.shape[1], "float32", 4,
                              False)
    _kernel_line("robust_aggregator, round liveness", ROBUST_SHAPE, "float32", 0.0, ms, plain,
                 None, b_ms, b_by, f", in a graph {in_graph * 1e3:.3f} us (ring, "
                 f"{ROBUST_EDGE_DROP:.0%} drops, trimmed_mean b=1)")
    # The timeline bitwise its plain version on the card: the churn GT cell's
    # processes, the burst sweep's and iid stragglers with participation, at
    # horizons across the kernels' segment and tile edges and the sweep's.
    topo = pkg.build_topology("ring", CHURN_BASE["n_workers"])
    modes = (_BURSTY_CHURN, dict(edge_drop_prob=CHURN_P, burst_len=4.0),
             dict(straggler_prob=0.1, participation_rate=0.7, edge_drop_prob=0.2,
                  burst_len=1.0))
    horizons = TIMELINE_HORIZONS + (CHURN_BASE["n_iterations"],)
    for horizon in horizons:
        for kw in modes:
            args, _ = faults.timeline_args(topo, 203, device=dev, x64=False, **_timeline_kw(kw))
            _timeline_is_the_twin_s(torch, dk, args, horizon, dev, f"N=16 T={horizon} {kw}")
    say(f"[faults] fault_timeline bitwise its plain version at T = {horizons} (N=16 ring): "
        "the churn GT cell, the burst sweep's B=4, iid stragglers with participation")
    # Its timed shapes, each bitwise the plain version: the launches alone,
    # their keys, edge list and thresholds built once.
    for label, n, horizon, kw in TIMELINE_SHAPES:
        topo = pkg.build_topology("ring", n)
        args, edge_index = faults.timeline_args(topo, 203, device=dev, x64=False,
                                                **_timeline_kw(kw))
        plain = _timeline_is_the_twin_s(torch, dk, args, horizon, dev,
                                        f"{label} N={n} T={horizon}")

        def call():
            return dk.fault_timeline(horizon=horizon, device=dev, **args)

        ms = time_ms(torch, call, n=20)
        in_graph = graph_ms(torch, call, n=20)
        edges = len(edge_index)
        nodes = n if args["node_chain"] is not None else 0
        streams = (edges > 0) + (nodes > 0)
        b_ms, b_by = timeline_bound(horizon, edges, nodes, 0, streams)
        extra = f" ({label}: {kw}), in a graph {in_graph * 1e3:.3f} us"
        if label == "churn_gt":
            setup = time_ms(torch, lambda: faults._timeline_tensors(
                topo, horizon, 203, device=dev, x64=False, **_timeline_kw(kw)), n=20)
            extra += (f"; the set-up call from the topology (edge list, keys, host-to-device "
                      f"copy) {setup * 1e3:.2f} us")
            records["fault_timeline"] = _record("fault_timeline", 0.0, ms, plain, b_ms, b_by,
                                                None, graph_ms=in_graph,
                                                shape=[horizon, edges + nodes], dtype="bool")
        _kernel_line("fault_timeline", (horizon, edges + nodes), "bool", 0.0, ms, plain, None,
                     b_ms, b_by, extra)
    # The noise payload: bitwise its plain version at every shape, three
    # counters each, every tenth row Byzantine; timed at NOISE_TIMED.
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        key = pkg.prng.fold_in(pkg.prng.key(203, x64=dtype == torch.float64), 0xBAD0)
        for n, d in NOISE_CHECK_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(n + d)
            x = torch.randn((n, d), generator=gen, device=dev, dtype=dtype)
            byz = (torch.arange(n, device=dev) % 10 == 3).to(torch.uint8)
            for t in (0, 4000, 2**31 - 1):
                tt = torch.tensor([t], device=dev)
                got = dk.large_noise(key, tt, byz, x, 10.0)
                check(torch.equal(got, dk.large_noise_plain(key, tt, byz, x, 10.0))
                      and torch.equal(got[byz == 0], x[byz == 0]),
                      f"large_noise {dtype} N={n} d={d} t={t}: not bitwise its plain version")
            if (n, d) not in NOISE_TIMED:
                continue
            if (n, d) == NOISE_SHAPE:
                byz = torch.as_tensor(pkg.byzantine_mask(n, 6, 203), dtype=torch.uint8,
                                      device=dev)
            tt = torch.tensor([77], device=dev)
            ms = time_ms(torch, lambda: dk.large_noise(key, tt, byz, x, 10.0))
            in_graph = graph_ms(torch, lambda: dk.large_noise(key, tt, byz, x, 10.0))
            plain = time_ms(torch, lambda: dk.large_noise_plain(key, tt, byz, x, 10.0),
                            n=20 if n * d < 1 << 22 else 3)
            b_ms, b_by = noise_bound(n, d, int(byz.sum()), dname, dtype.itemsize)
            _kernel_line("large_noise", (n, d), dname, 0.0, ms, plain, None, b_ms, b_by,
                         f", in a graph {in_graph * 1e3:.3f} us ({int(byz.sum())} of {n} rows "
                         "Byzantine)")
            if (n, d) == NOISE_SHAPE and dtype == torch.float32:
                records["large_noise"] = _record("large_noise", 0.0, ms, plain, b_ms, b_by,
                                                 None, graph_ms=in_graph, shape=[n, d],
                                                 dtype="float32")
    say(f"[faults] large_noise bitwise its plain version in both dtypes at N×d = "
        f"{', '.join(f'{n}×{d}' for n, d in NOISE_CHECK_SHAPES)}, 3 counters each; honest rows "
        "equal x")
    return records


def full_width_data(pkg, main=None):
    """The full-width runs' data and optima: main's (N=256; ``main`` where
    the caller has it) and the robust cell's."""
    rcfg = robust_config(pkg)
    rds = pkg.generate_synthetic_dataset(rcfg)
    return {"main": main or _main_data(pkg, 256),
            "robust": (rds, pkg.compute_reference_optimum(rds, rcfg.reg_param)[1])}


def full_width_runs(torch, np, pkg, kernels, data, label="faults"):
    """Main's shapes under bursty drops and churn (FULL_WIDTH_FAULTS) and the
    robust cell under large_noise (12 Byzantine rows, scale 10, trimmed mean
    b=1, fused and gather). ``data``: ``full_width_data``'s. Each run
    launches fault_timeline exactly TIMELINE_LAUNCHES times and large_noise
    T times. The timeline the main run itself built on the card is held
    bitwise against the plain version on the CPU (drawn in a thread while
    the card runs), and its graph run against its measured run (T =
    FULL_WIDTH_MEASURED)."""
    import concurrent.futures

    from distributed_optimization_tpu_torch.backends import torch_backend
    from distributed_optimization_tpu_torch.parallel import faults

    dk, sk, rk, bk = kernels["dk"], kernels["sk"], kernels["rk"], kernels["bk"]
    counters = [dk, sk, rk, bk]
    cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                               n_workers=256, n_iterations=MAIN_ITERATIONS, mixing_impl="pallas",
                               dtype="float32", eval_every=1, **FULL_WIDTH_FAULTS)
    ds, f_opt = data["main"]
    T = cfg.n_iterations
    topo = pkg.build_topology("ring", cfg.n_workers)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(faults.timeline_for_config, cfg, topo, T, device="cpu")
        # made: the main run's FaultyMixing, as the run built it.
        with _kept(torch_backend, "make_faulty_mixing") as made:
            res, launches = _converging_run(torch, pkg, counters, cfg, ds, f_opt,
                                            f"{label} full width", converges=False)
        h = res.history
        say(f"[{label}] full width, main's shapes under bursty drops and churn: set-up "
            f"{h.fault_setup_seconds:.4f} s (timeline included), warm-up and capture "
            f"{h.compile_seconds:.2f} s, {h.iters_per_second:.1f} iters/s in the graph, gap "
            f"history sha256 {_digest(np, h.objective)}")
        check(launches.get("realize_round") == T
              and launches.get("sample_worker_batch_weights") == T
              and launches.get("fault_timeline", 0) == dk.TIMELINE_LAUNCHES
              and not launches.get("fused_ring_dsgd_step") and len(made) == 1,
              f"{label} full width: launches {launches} (fault_timeline: "
              f"{dk.TIMELINE_LAUNCHES} wanted), {len(made)} fault processes made")
        short = cfg.replace(n_iterations=FULL_WIDTH_MEASURED)
        graph, glaunch = _converging_run(torch, pkg, counters, short, ds, f_opt,
                                         f"{label} full width", converges=False)
        _graph_equals_measured(torch, np, pkg, counters, short, ds, f_opt,
                               f"{label} full width", graph, glaunch, converges=False)
        base = robust_config(pkg).replace(attack="large_noise", n_byzantine=12,
                                          attack_scale=10.0, aggregation="trimmed_mean",
                                          robust_b=1)
        rds, rf = data["robust"]
        for impl in ("fused", "gather"):
            rcfg = base.replace(robust_impl=impl)
            res, launches = _converging_run(torch, pkg, counters, rcfg, rds, rf,
                                            f"{label} robust noise", converges=False)
            h = res.history
            say(f"[{label}] robust cell under large_noise (scale 10), trimmed mean b=1, {impl}: "
                f"large_noise {launches.get('large_noise')} launches, "
                f"{h.iters_per_second:.1f} iters/s, final gap {h.objective[-1]:.6f}, gap "
                f"history sha256 {_digest(np, h.objective)}")
            check(launches.get("large_noise", 0) == rcfg.n_iterations
                  and launches.get("make_fused_robust_dsgd_step", 0)
                  == (rcfg.n_iterations if impl == "fused" else 0),
                  f"{label} robust noise {impl}: launches {launches}")
        run = made[0]
        want = host.result()
        same = all(np.array_equal(getattr(run.timeline, f), getattr(want, f))
                   for f in ("edge_up", "node_up", "rejoin"))
        same = same and all(torch.equal(getattr(run._tl, f).cpu(),
                                        torch.from_numpy(getattr(want, f)))
                            for f in ("edge_up", "node_up"))
        say(f"[{label}] full width: the timeline the run drew on the card ({T} × "
            f"{want.edge_up.shape[1]} edges, {T} × {want.node_up.shape[1]} nodes) "
            f"{'bitwise equal to' if same else 'DIFFERS from'} the plain version's on the "
            "CPU")
        check(same and want.part_up is None and run._tl.part_up is None,
              f"{label} full width: the timeline differs")


def phase_faults(torch, np, pkg, kernels):
    """bench_faults.py's twelve variants, main's shapes under faults, each
    fault mode in float64 against the CPU. Returns the faulted main run's
    realize_round launches."""
    dk, sk, rk, bk = kernels["dk"], kernels["sk"], kernels["rk"], kernels["bk"]
    counters = [dk, sk, rk, bk]
    base = pkg.ExperimentConfig(**FAULTS_BASE)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param)
    T = base.n_iterations
    d = base.n_features + 1
    floats = {}
    for name, (fields, jax_iters, jax_gap, jax_floats) in FAULT_ROWS.items():
        cfg = base.replace(**fields)
        res, launches = _converging_run(torch, pkg, counters, cfg, ds, f_opt, "faults",
                                        converges=jax_iters > 0)
        h = res.history
        crossed = pkg.iterations_to_threshold(h.objective, cfg.suboptimality_threshold,
                                              h.eval_iterations)
        gap = float(h.objective[-1])
        say(f"[faults] {name:22s} iters-to-ε {crossed:6d}, JAX package {jax_iters:6d} "
            f"({(crossed - jax_iters) / jax_iters:+.3%}); final gap {gap:.6f} (JAX {jax_gap:.6f}); "
            f"floats {h.total_floats_transmitted:.0f} (JAX {jax_floats:.0f}); "
            f"{h.iters_per_second:.1f} iters/s (warm-up and capture {h.compile_seconds:.2f} s)")
        if jax_iters > 0:
            check(abs(crossed - jax_iters) <= COUNT_TOLERANCE * jax_iters,
                  f"faults {name}: {crossed} iterations, not within 1% of {jax_iters}")
        else:
            check(crossed == -1 and abs(gap - jax_gap) <= 0.01 * jax_gap,
                  f"faults {name}: crossed {crossed} / gap {gap} vs the JAX package's {jax_gap}")
        check(h.total_floats_transmitted == jax_floats,
              f"faults {name}: floats {h.total_floats_transmitted} vs the JAX package's "
              f"{jax_floats}")
        draws = cfg.faults_active or cfg.gossip_schedule == "one_peer"
        check(launches.get("realize_round", 0) == (T if draws else 0),
              f"faults {name}: realize_round launched {launches.get('realize_round')} times")
        check(launches.get("sample_worker_batches") == T and not launches.get("fault_timeline")
              and not launches.get("fused_ring_dsgd_step"),
              f"faults {name}: launches {launches}")
        floats[name] = h.total_floats_transmitted
        if not cfg.time_varying:
            topo = pkg.build_topology(cfg.topology, cfg.n_workers)
            payload = d + 1 if cfg.algorithm == "push_sum" else d * (
                2 if cfg.algorithm == "gradient_tracking" else 1)
            analytic = topo.floats_per_iteration * payload * T
            check(h.total_floats_transmitted == analytic,
                  f"faults {name}: fault-free floats {h.total_floats_transmitted} != "
                  f"2|E|·payload·T = {analytic}")
    check(floats["round_robin_matchings"] == 0.5 * floats["fault_free"],
          "round-robin floats are not exactly half the fault-free count")
    say("[faults] fault-free floats equal 2|E|·payload·T; round-robin exactly half")

    # Main's shapes under faults: the realization kernel at the main path's width.
    main = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                                n_workers=256, n_iterations=MAIN_ITERATIONS, mixing_impl="pallas",
                                dtype="float32", eval_every=1, **FAULT_MAIN)
    mds = pkg.generate_synthetic_dataset(main)
    _, mf = pkg.compute_reference_optimum(mds, main.reg_param)
    res, launches = _converging_run(torch, pkg, counters, main, mds, mf, "faults main",
                                    converges=False)
    T = main.n_iterations
    check(launches.get("realize_round") == T and launches.get("sample_worker_batch_weights") == T
          and not launches.get("fused_ring_dsgd_step") and not launches.get("ring_mix"),
          f"faults main: launches {launches}")
    main_launches = launches
    short = main.replace(n_iterations=FAULT_MAIN_MEASURED)
    graph, glaunch = _converging_run(torch, pkg, counters, short, mds, mf, "faults main",
                                     converges=False)
    _graph_equals_measured(torch, np, pkg, counters, short, mds, mf, "faults main", graph,
                           glaunch, converges=False)

    full_width_runs(torch, np, pkg, kernels, full_width_data(pkg, (mds, mf)))

    # Each fault mode in float64, card against the CPU.
    small = base.replace(dtype="float64", n_iterations=FAULT_F64_ITERATIONS, eval_every=10)
    for name, fields in FAULT_F64.items():
        cfg = small.replace(**fields)
        _agree(f"N=64 T={cfg.n_iterations} float64 {name}", pkg.run(cfg, ds, f_opt, device="cuda"),
               pkg.run(cfg, ds, f_opt, device="cpu"), phase="faults")
    return main_launches


def phase_churn(torch, np, pkg, kernels):
    """bench_churn.py's four gates on the card. Returns the launches of one
    run, the GT churn cell's, counted from 0 just before it."""
    dk, sk = kernels["dk"], kernels["sk"]
    base = pkg.ExperimentConfig(**CHURN_BASE)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param)
    topo = pkg.build_topology("ring", base.n_workers)
    counts = {}

    def churn_run(label, cfg, **kw):
        for c in (dk, sk):
            c.reset_launch_counts()
        res = pkg.run(cfg, ds, f_opt, device="cuda", **kw)
        launches = {k: v for c in (dk, sk) for k, v in c.LAUNCHES.items() if v}
        counts[label] = launches
        h = res.history
        say(f"[churn] {label:24s} final gap {h.objective[-1]:.6e}, mean consensus "
            f"{np.mean(h.consensus_error):.6e}, final consensus {h.consensus_error[-1]:.6e}, "
            f"floats {h.total_floats_transmitted:.0f}, {h.iters_per_second:.1f} iters/s "
            f"(timeline set-up {h.fault_setup_seconds * 1e3:.2f} ms, warm-up and capture "
            f"{h.compile_seconds:.2f} s), launches {launches}, gap history sha256 "
            f"{_digest(np, h.objective)}")
        check(bool(np.all(np.isfinite(h.objective))), f"churn {label}: non-finite gaps")
        persistent = cfg.burst_len >= 1.0 or cfg.mttf > 0.0
        check(launches.get("fault_timeline", 0) == (dk.TIMELINE_LAUNCHES if persistent else 0)
              and launches.get("realize_round", 0) == cfg.n_iterations,
              f"churn {label}: launches {launches}")
        return res

    iid = churn_run("iid_p03", base.replace(edge_drop_prob=CHURN_P))
    runs, bhat = {}, {}
    for B in CHURN_BURSTS:
        runs[B] = churn_run(f"burst_{B:g}", base.replace(edge_drop_prob=CHURN_P, burst_len=B))
        tl = pkg.build_fault_timeline(topo, base.n_iterations, base.seed,
                                      edge_drop_prob=CHURN_P, burst_len=B, device="cuda")
        bhat[B] = pkg.windowed_connectivity(tl, topo)
        say(f"[churn] burst {B:g}: marginal drop rate {1.0 - tl.edge_up.mean():.5f}, "
            f"B-hat {bhat[B]}")
    same = (np.array_equal(runs[1.0].history.objective, iid.history.objective)
            and np.array_equal(runs[1.0].history.consensus_error, iid.history.consensus_error)
            and runs[1.0].history.total_floats_transmitted == iid.history.total_floats_transmitted)
    say(f"[churn] gate 1: burst_len=1 {'bitwise equal to' if same else 'DIFFERS from'} the "
        "iid run (timeline kernel against the per-round realization kernel)")
    check(same, "churn: burst_len=1 is not bitwise the iid run")
    values = [bhat[B] for B in CHURN_BURSTS]
    cons = [float(np.mean(runs[B].history.consensus_error)) for B in CHURN_BURSTS]
    say(f"[churn] gate 2: B-hat by burst length {values}; mean consensus {cons} (printed)")
    check(all(v is not None for v in values)
          and all(a <= b for a, b in zip(values, values[1:])) and values[0] < values[-1],
          f"churn: B-hat does not grow with the burst length: {values}")
    gt = churn_run("gt_churn_frozen", base.replace(**CHURN_GT), return_state=True)
    resid = float(np.abs(gt.final_state["y"].mean(axis=0)
                         - gt.final_state["g_prev"].mean(axis=0)).max())
    say(f"[churn] gate 3: GT tracking residual under churn (float64) {resid:.3e}")
    check(resid < 1e-9, f"churn: GT tracking residual {resid} not below 1e-9")
    frozen = churn_run("outage_frozen", base.replace(**CHURN_OUTAGE))
    restart = churn_run("outage_neighbor_restart",
                        base.replace(**CHURN_OUTAGE, rejoin="neighbor_restart"))
    tl = pkg.build_fault_timeline(topo, CHURN_OUTAGE["n_iterations"], base.seed, mttf=400.0,
                                  mttr=150.0, device="cuda")
    stats = pkg.outage_stats(tl)
    fc, rc = float(frozen.history.consensus_error[-1]), float(restart.history.consensus_error[-1])
    say(f"[churn] gate 4: outages {stats}; final consensus neighbor_restart {rc:.6e} vs "
        f"frozen {fc:.6e}")
    check(stats["max_outage_rounds"] >= 50, "churn: no long outage")
    check(rc <= fc, f"churn: neighbor_restart {rc} ends above frozen {fc}")
    return counts["gt_churn_frozen"]


# --- the replica axis (run_batch) ------------------------------------------------

# Replicas a launch for the kernels' times: one, a sweep's eight, the 32 of
# the sweep benches' largest cell.
REPLICA_TIMED = (1, 8, 32)
REPLICA_CHECKED = (1, 3, 8, 32)
REPLICA_SEEDS = tuple(range(203, 203 + 32))
# examples/bench_sweep.py:84-102 (its two cells) and its η₀ sweep.
SWEEP_CELLS = {"flagship_n25": (dict(n_iterations=2000, eval_every=500), (1, 2, 4, 8, 16, 32)),
               "northstar_n256": (dict(n_workers=256, n_iterations=400, eval_every=100), (8, 32))}
SWEEP_ETAS = (0.01, 0.02, 0.05, 0.08, 0.1, 0.15, 0.2, 0.3)
# The full-width replica run: main's config at R = 8, seeds 203-210; its
# graph-vs-measured check's T; the float64 card-vs-CPU check (R = 3, T).
REPLICA_MAIN_R = 8
REPLICA_MEASURED = 1_000
REPLICA_F64 = (3, 100)
# Main's shapes under bursty drops and churn with sign-flip and the gather
# trimmed mean, at R = 4 against the sequential runs, and the robust cell
# under large_noise at R = 4 (the noise kernel's replica path).
REPLICA_BYZ = dict(FULL_WIDTH_FAULTS, attack="sign_flip", n_byzantine=12,
                   aggregation="trimmed_mean", robust_b=1, robust_impl="gather")
REPLICA_BYZ_T = 3_000
# Its gaps against the sequential runs': the two differ only in the order of
# their float32 products (the batch's skinny product a worker, in the
# gradients and the objective), a spread under 1e-6 relative; a fault in a
# replica's Byzantine rows, noise or screen would move the gaps far more.
REPLICA_BYZ_GAP_RTOL = 1e-4
REPLICA_NOISE_T = 1_000


def _replica_calls(torch, pkg, kernels, name, R):
    """(one launch for R replicas, R single launches, the plain stack, bound
    (ms, by), largest |launch − plain|) for one replica-axis kernel at its
    path's shape in float32, and checks that the launch is its plain stack
    bitwise and that replica r of it is single launch r bitwise."""
    from distributed_optimization_tpu_torch.ops import sampling
    from distributed_optimization_tpu_torch.parallel import faults

    dk, sk, prng = kernels["dk"], kernels["sk"], pkg.prng
    dev = torch.device("cuda")
    seeds = list(REPLICA_SEEDS[:R])
    t = torch.tensor([12_345], device=dev)
    if name in ("sample_worker_batch_weights", "sample_worker_batches"):
        _, n, L, b = SAMPLING_RECORD[name]
        nv = sampling_n_valid(torch, n, L, b)
        X, y = sampling_rows(torch, n, L, torch.float32)
        keys = prng.keys(seeds, x64=False, tags=(0,), device=dev)
        singles = [prng.fold_in(prng.key(s, x64=False), 0) for s in seeds]
        if name == "sample_worker_batch_weights":
            def call(k, form=sk):
                return (form.sample_worker_batch_weights(k, t, nv, L, b, torch.float32),)
        else:
            def call(k, form=sk):
                return form.sample_worker_batches(k, t, X, y, nv, b)
        plain = lambda: call(keys, sampling)  # noqa: E731
        b_ms, b_by = sampling_bound(name, R * n, L, b, 4)
    elif name == "realize_round":
        topo = pkg.build_topology("ring", 256)
        fm = faults.make_faulty_mixing(topo, 0.2, seeds, straggler_prob=0.1, device=dev)
        ones = [faults.make_faulty_mixing(topo, 0.2, s, straggler_prob=0.1, device=dev)
                for s in seeds]
        kw = dict(drop_prob=0.2, straggler_prob=0.1, weights=torch.float32)
        total = torch.zeros(R, dtype=torch.float64, device=dev)
        one_total = torch.zeros((), dtype=torch.float64, device=dev)
        keys, singles = fm._keys, [m._keys for m in ones]

        def call(k):
            tot = total if isinstance(k, torch.Tensor) else one_total
            return dk.realize_round(t, k, fm._tables, degree_total=tot, **kw)[:3]
        plain = lambda: dk._replica_rounds(  # noqa: E731
            t, keys, fm._tables, timeline=None, scores=False, degree_total=total, **kw)[:3]
        b_ms, b_by = realize_bound(fm._tables, 4)
        b_ms *= R  # R rounds' work
    else:
        n, d = NOISE_SHAPE
        x = torch.randn((R, n, d), generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev)
        byz = torch.stack([torch.as_tensor(pkg.byzantine_mask(n, 6, s), dtype=torch.uint8,
                                           device=dev) for s in seeds])
        keys = prng.keys(seeds, x64=False, tags=(0xBAD0,), device=dev)
        singles = [prng.fold_in(prng.key(s, x64=False), 0xBAD0) for s in seeds]
        rows = [(byz[r].contiguous(), x[r].contiguous()) for r in range(R)]

        def call(k, r=None):
            if isinstance(k, torch.Tensor):
                return (dk.large_noise(k, t, byz, x, 10.0),)
            return (dk.large_noise(k, t, *rows[r], 10.0),)
        plain = lambda: (torch.stack([dk.large_noise_plain(  # noqa: E731
            k, t, byz[r], x[r], 10.0) for r, k in enumerate(singles)]),)
        b_ms, b_by = noise_bound(R * n, d, int(byz.sum()), "float32", 4)
    batched = lambda: call(keys)  # noqa: E731
    if name == "large_noise":
        one_by_one = lambda: [call(k, r) for r, k in enumerate(singles)]  # noqa: E731
    else:
        one_by_one = lambda: [call(k) for k in singles]  # noqa: E731
    got, want = batched(), plain()
    err = max(float((a.double() - w.double()).abs().max()) for a, w in zip(got, want))
    check(_same(torch, got, want),
          f"replicas: {name} at R={R} not bitwise its plain version (max diff {err:.3e})")
    for r, k in enumerate(singles):
        want = call(k, r) if name == "large_noise" else call(k)
        check(all(torch.equal(a[r], w) for a, w in zip(got, want)),
              f"replicas: {name} replica {r} of R={R} not bitwise its single launch")
    return batched, one_by_one, plain, (b_ms, b_by), err


def replica_kernel_records(torch, pkg, kernels):
    """Each replica-axis kernel at its path's shape: one launch bitwise its
    plain stack, and replica r of it bitwise single launch r, at R = 1, 3,
    8, 32; in a graph of 200, one
    launch for R against R single launches, beside the bound, at R = 1, 8,
    32; the R = 32 launch event-timed and its plain stack timed for the
    record. Returns the records."""
    records = {}
    for name in REPLICA_KERNELS:
        for R in REPLICA_CHECKED:
            _replica_calls(torch, pkg, kernels, name, R)
        line = []
        for R in REPLICA_TIMED:
            batched, singles, plain, (b_ms, b_by), err = _replica_calls(
                torch, pkg, kernels, name, R)
            one = graph_ms(torch, batched)
            many = graph_ms(torch, singles, n=max(1, TIMED_LAUNCHES // R))
            line.append(f"R={R}: {one * 1e3:.3f} us one launch, {many * 1e3:.3f} us {R} single "
                        f"launches, bound {b_ms * 1e3:.4f} us ({b_by})")
            if R == REPLICA_TIMED[-1]:
                ms = time_ms(torch, batched)
                plain_ms = time_ms(torch, plain, n=3)
                records[f"{name}, replica axis"] = _record(
                    f"{name}, replica axis", err, ms, plain_ms, b_ms, b_by, None, graph_ms=one,
                    replicas=R, singles_graph_ms=many)
                _kernel_line(f"{name} R={R}", "path shape", "float32", err, ms, plain_ms,
                             None, b_ms, b_by, f", in a graph {one * 1e3:.3f} us")
        say(f"[replicas] {name} at its path's shape, in a graph of {TIMED_LAUNCHES}: "
            + "; ".join(line))
    say(f"[replicas] every launch bitwise its plain stack and each replica of it bitwise its "
        f"single launch at R = {REPLICA_CHECKED} ({', '.join(REPLICA_KERNELS)})")
    return records


def _batch_run(torch, pkg, counters, cfg, ds, f_opt, seeds, label, **kw):
    """One run_batch on the card with its launch counts (zeroed just before)."""
    import numpy as np

    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    res = pkg.run_batch(cfg, ds, f_opt, seeds=list(seeds), device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items() if v}
    crossed = [pkg.iterations_to_threshold(res.objective[r], cfg.suboptimality_threshold,
                                           res.results[0].history.eval_iterations)
               for r in range(len(seeds))]
    say(f"[{label}] R={len(seeds)} N={cfg.n_workers} T={cfg.n_iterations} eval every "
        f"{cfg.eval_every}{' (measured chunk loop)' if kw.get('measure_timestamps') else ''}: "
        f"{res.aggregate_iters_per_second:.1f} aggregate iters/s "
        f"({res.aggregate_iters_per_second / len(seeds):.1f} a replica), warm-up and capture "
        f"{res.compile_seconds:.2f} s, whole call {wall:.2f} s; iters-to-"
        f"{cfg.suboptimality_threshold} {crossed}; final gaps "
        f"{[round(float(v), 6) for v in res.objective[:, -1]]}; launches {launches}; gap "
        f"history sha256 {_digest(np, res.objective)}")
    check(bool(np.all(np.isfinite(res.objective))), f"{label}: non-finite gaps")
    return res, launches, crossed


def phase_replicas(torch, np, pkg, kernels, main_res=None):
    """The replica axis (``torch_backend.run_batch``) on the card: the
    kernels' replica checks and times; bench_sweep.py's two cells beside the
    single run and its η₀ sweep; main's config at R = 8 (every replica
    crosses ε, replica 0 within 1% of the main phase's count, the graph run
    bitwise its measured run), float64 R = 3 against the CPU; main's shapes
    under bursty drops, churn, sign-flip and the gather trimmed mean at R =
    4 (floats exact against the sequential runs); the robust cell under
    large_noise at R = 4. Returns (records, launches on the phase's runs)."""
    dk, sk, rk, bk = kernels["dk"], kernels["sk"], kernels["rk"], kernels["bk"]
    counters = [dk, sk, rk, bk]
    records = replica_kernel_records(torch, pkg, kernels)
    # Each kernel's launches on its replica path (the counts zeroed just
    # before that run and read just after it).
    counted = {}

    def note(name, launches):
        counted[f"{name}, replica axis"] = launches.get(name, 0)

    # bench_sweep.py's cells, each beside the single run in this call.
    base = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                                dtype="float32")
    for cell, (fields, r_points) in SWEEP_CELLS.items():
        cfg = base.replace(**fields)
        ds, f_opt = _main_data(pkg, cfg.n_workers)
        single, launches = _converging_run(torch, pkg, counters, cfg, ds, f_opt,
                                           f"replicas {cell} single", converges=False)
        one = single.history.iters_per_second
        rows = []
        for R in r_points:
            res, launches, _ = _batch_run(torch, pkg, counters, cfg, ds, f_opt,
                                          [cfg.seed + i for i in range(R)], f"replicas {cell}")
            sampler = "sample_worker_batches" if cfg.n_workers == 25 else \
                "sample_worker_batch_weights"
            check(launches.get(sampler) == cfg.n_iterations,
                  f"replicas {cell} R={R}: {sampler} launched {launches.get(sampler)} times, "
                  f"not T")
            if sampler == "sample_worker_batches":
                note(sampler, launches)
            rows.append(f"R={R} {res.aggregate_iters_per_second:.1f} "
                        f"({res.aggregate_iters_per_second / one:.2f}x)")
        say(f"[replicas] {cell}: single run {one:.1f} iters/s; aggregate " + ", ".join(rows))
    cfg = base.replace(n_iterations=1000, eval_every=250)
    ds, f_opt = _main_data(pkg, cfg.n_workers)
    res, _, _ = _batch_run(torch, pkg, counters, cfg, ds, f_opt, [cfg.seed] * len(SWEEP_ETAS),
                           "replicas eta0 sweep", sweep={"learning_rate_eta0": list(SWEEP_ETAS)})
    say(f"[replicas] eta0 sweep {SWEEP_ETAS}: final gaps "
        f"{[round(float(v), 6) for v in res.objective[:, -1]]}")
    # Main's config at full width, R = 8.
    main_cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                                    n_workers=256, n_iterations=MAIN_ITERATIONS,
                                    dtype="float32", eval_every=1)
    ds, f_opt = _main_data(pkg, 256)
    if main_res is None:
        main_res, _ = _converging_run(torch, pkg, counters, main_cfg, ds, f_opt,
                                      "replicas main single")
    want = pkg.iterations_to_threshold(main_res.history.objective, 0.08,
                                       main_res.history.eval_iterations)
    seeds = REPLICA_SEEDS[:REPLICA_MAIN_R]
    res, launches, crossed = _batch_run(torch, pkg, counters, main_cfg, ds, f_opt, seeds,
                                        "replicas main")
    note("sample_worker_batch_weights", launches)
    check(all(0 < c <= MAIN_ITERATIONS for c in crossed),
          f"replicas main: a replica never crossed ε ({crossed})")
    check(abs(crossed[0] - want) <= COUNT_TOLERANCE * want,
          f"replicas main: replica 0 crossed at {crossed[0]}, the main phase at {want}")
    check(launches.get("sample_worker_batch_weights") == MAIN_ITERATIONS,
          f"replicas main: launches {launches}")
    say(f"[replicas] main R={REPLICA_MAIN_R}: replica 0 crossed at {crossed[0]}, the main "
        f"phase's run at {want}")
    short = main_cfg.replace(n_iterations=REPLICA_MEASURED)
    graph, glaunch, _ = _batch_run(torch, pkg, counters, short, ds, f_opt, seeds,
                                   "replicas main")
    measured, mlaunch, _ = _batch_run(torch, pkg, counters, short, ds, f_opt, seeds,
                                      "replicas main", measure_timestamps=True)
    same = (np.array_equal(graph.objective, measured.objective)
            and np.array_equal(graph.consensus_error, measured.consensus_error)
            and np.array_equal(graph.final_states["x"], measured.final_states["x"]))
    say(f"[replicas] main R={REPLICA_MAIN_R} T={REPLICA_MEASURED}: graph run vs measured chunk "
        f"loop {'bitwise equal' if same else 'DIFFER'}, launches {glaunch} vs {mlaunch}")
    check(same and glaunch == mlaunch, "replicas main: the graph run is not its measured run")
    # Float64, R = 3: the card against the CPU.
    R, T = REPLICA_F64
    f64 = main_cfg.replace(dtype="float64", n_iterations=T, eval_every=10,
                           sampling_impl="dense")
    card, _, _ = _batch_run(torch, pkg, counters, f64, ds, f_opt, REPLICA_SEEDS[:R],
                            "replicas float64")
    host = pkg.run_batch(f64, ds, f_opt, seeds=list(REPLICA_SEEDS[:R]), device="cpu")
    worst = 0.0
    for card_a, host_a in ((card.objective, host.objective),
                           (card.consensus_error, host.consensus_error),
                           (card.final_states["x"], host.final_states["x"])):
        worst = max(worst, float(np.max(np.abs(card_a - host_a) / (1.0 + np.abs(host_a)))))
        check(np.allclose(card_a, host_a, rtol=1e-12, atol=1e-12),
              "replicas float64: the card's batch and the CPU's disagree beyond 1e-12")
    say(f"[replicas] float64 R={R} T={T} (N=256, dense sampling) on the card vs plain on the "
        f"CPU: gaps, consensus and final models within 1e-12 (largest |diff| / (1 + |x|) "
        f"{worst:.3e})")
    # Faulted + Byzantine at R = 4 against the sequential runs.
    byz = main_cfg.replace(n_iterations=REPLICA_BYZ_T, eval_every=10, **REPLICA_BYZ)
    seeds = REPLICA_SEEDS[:4]
    res, launches, _ = _batch_run(torch, pkg, counters, byz, ds, f_opt, seeds,
                                  "replicas faults+byzantine")
    note("realize_round", launches)
    check(launches.get("realize_round") == REPLICA_BYZ_T
          and launches.get("fault_timeline") == len(seeds) * dk.TIMELINE_LAUNCHES,
          f"replicas faults+byzantine: launches {launches}")
    floats = []
    for r, seed in enumerate(seeds):
        seq, _ = _converging_run(torch, pkg, counters, byz.replace(
            seed=seed, topology_seed=byz.resolved_topology_seed()), ds, f_opt,
            "replicas faults+byzantine sequential", converges=False)
        floats.append((res.results[r].history.total_floats_transmitted,
                       seq.history.total_floats_transmitted))
        rel = float(np.max(np.abs(res.objective[r] - seq.history.objective)
                           / np.abs(seq.history.objective)))
        say(f"[replicas] faults+byzantine replica {r}: floats {floats[-1][0]:.0f} (sequential "
            f"{floats[-1][1]:.0f}); largest relative gap difference {rel:.3e} (float32, two "
            "product orders)")
        check(rel <= REPLICA_BYZ_GAP_RTOL,
              f"replicas faults+byzantine replica {r}: gaps {rel:.3e} from the sequential "
              f"run's, beyond {REPLICA_BYZ_GAP_RTOL}")
    check(all(a == b for a, b in floats), f"replicas faults+byzantine: floats {floats}")
    rcfg = robust_config(pkg, REPLICA_NOISE_T).replace(
        mixing_impl="auto", attack="large_noise", n_byzantine=12, attack_scale=10.0,
        aggregation="trimmed_mean", robust_b=1, robust_impl="gather")
    rds = pkg.generate_synthetic_dataset(rcfg)
    rf = pkg.compute_reference_optimum(rds, rcfg.reg_param)[1]
    res, launches, _ = _batch_run(torch, pkg, counters, rcfg, rds, rf, seeds,
                                  "replicas robust noise")
    note("large_noise", launches)
    check(launches.get("large_noise") == REPLICA_NOISE_T,
          f"replicas robust noise: launches {launches}")
    return records, counted


def _slot_topology(pkg, label):
    """The matrix-free graph of a SLOT_ROWS row."""
    if label == "er_100k":
        return pkg.build_topology("erdos_renyi", ER_100K["n_workers"],
                                  erdos_renyi_p=ER_100K["erdos_renyi_p"],
                                  seed=ER_100K["topology_seed"], impl="neighbor",
                                  sampler="sparse")
    return pkg.build_topology("ring", 256, impl="neighbor")


def _slot_round_is_the_twin_s(torch, dk, fm, t, dtype, what):
    """One launch pair of the slot round against its plain version on the
    same card tensors: live, w, w_self, active and the degree count bit for
    bit."""
    tt = torch.tensor([t], device="cuda")
    total = torch.full((), 5.0, dtype=torch.float64, device="cuda")
    want_total = torch.full((), 5.0, dtype=torch.float64, device="cuda")
    got = dk.realize_slot_round(tt, fm._slots, fm._tl, weights=dtype, degree_total=total)
    want = dk.realize_slot_round_plain(tt, fm._slots, fm._tl, weights=dtype,
                                       degree_total=want_total)
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(total, want_total),
          f"realize_slot_round {what} {dtype} t={t}: not bitwise its plain version")


def _slot_round_replicas_are_the_twin_s(torch, dk, faults, topo, horizon, fm_kw, label):
    """One launch pair of the slot round over R = 4 replicas' timelines
    against the plain version replica by replica, bitwise, both dtypes."""
    dev = torch.device("cuda")
    R = SLOT_REPLICAS
    for dtype in (torch.float32, torch.float64):
        fm = faults.make_faulty_mixing(topo, seed=list(range(203, 203 + R)), horizon=horizon,
                                       device=dev, x64=dtype == torch.float64, **fm_kw)
        for t in (0, 17, horizon + 40):
            tt = torch.tensor([t], device=dev)
            total = torch.zeros(R, dtype=torch.float64, device=dev)
            got = dk.realize_slot_round(tt, fm._slots, fm._tl, weights=dtype, degree_total=total,
                                        replicas=R)
            for r in range(R):
                want_total = torch.zeros((), dtype=torch.float64, device=dev)
                want = dk.realize_slot_round_plain(tt, fm._slots, fm._tl.replica(r),
                                                   weights=dtype, degree_total=want_total)
                check(all(torch.equal(a[r], b) for a, b in zip(got, want))
                      and float(total[r]) == float(want_total),
                      f"realize_slot_round {label} R={R} {dtype} t={t}: replica {r} is not "
                      "bitwise its plain version")
    say(f"[kernels] realize_slot_round {label}: R = {R} replicas in one launch pair, each "
        "bitwise its plain version (float32 and float64)")


def _caller_liveness_is_the_twin_s(torch, np, dk, fm, topo, horizon, label):
    """The live pass alone over a caller's tables (the topology's rows in
    reverse slot order, and a float mask with a hole: not a prefix) bitwise
    its plain version."""
    nbr, mask = topo.nbr_idx.copy(), topo.nbr_mask.copy()
    cnt = mask.sum(1)
    for i in np.nonzero(cnt > 1)[0]:
        nbr[i, :cnt[i]] = topo.nbr_idx[i, :cnt[i]][::-1]
    holed = np.where(mask, 0.5 + np.arange(mask.shape[1])[None, :], 0.0).astype(np.float32)
    holed[::3, 0] = 0.0
    for table in (fm.device_table(nbr, mask), fm.device_table(topo.nbr_idx, holed)):
        for t in (0, 17, horizon + 40):
            tt = torch.tensor([t], device="cuda")
            check(torch.equal(dk.slot_liveness(tt, table, fm._tl),
                              dk.slot_liveness_plain(tt, table, fm._tl)),
                  f"slot_liveness {label} t={t}: a caller's table is not bitwise the plain "
                  "version")
    say(f"[kernels] slot_liveness {label}: a caller's reordered table and a masked hole "
        "bitwise the plain version")


def kernels_matrix_free(torch, np, dk, pkg):
    """The matrix-free fault form's two kernel forms against their plain
    versions on the card, bitwise, at cell (ii)'s shape (ER N=100,000, p =
    16/N, the sparse sampler, 10% iid drops and participation 0.5) and on
    the ring at N=256 (bursty drops, churn, participation): the timeline's
    per-edge stream, and the slot round in both dtypes inside, at and past
    the horizon; each timed at cell (ii)'s shape (its record). Then the
    dense round past the 32-bit counter (``dense_round_past_2_32``)."""
    from distributed_optimization_tpu_torch.parallel import faults

    dev = torch.device("cuda")
    records = {}
    for label, (kw, horizon) in SLOT_ROWS.items():
        topo = _slot_topology(pkg, label)
        processes = {k: v for k, v in kw.items() if k != "rejoin"}
        args, edge_index = faults.timeline_args(topo, 203, device=dev, x64=False,
                                                **_timeline_kw(processes))
        check(args["edges"] is None and args["n_edges"] == len(edge_index),
              f"{label}: the timeline is not on the per-edge stream")
        plain = _timeline_is_the_twin_s(torch, dk, args, horizon, dev, f"per-edge {label}")
        edges, nodes = len(edge_index), (topo.n if args["node_chain"] is not None else 0)
        part = topo.n if args["p_out"] is not None else 0
        streams = 1 + (nodes > 0) + (part > 0)

        def call():
            return dk.fault_timeline(horizon=horizon, device=dev, **args)

        ms = time_ms(torch, call, n=20)
        in_graph = graph_ms(torch, call, n=20)
        b_ms, b_by = timeline_bound(horizon, edges, nodes, part, streams, edge_list=False)
        shape = (horizon, edges + nodes + part)
        _kernel_line("fault_timeline, per-edge stream", shape, "bool", 0.0, ms, plain, None,
                     b_ms, b_by, f" ({label}: {processes}), in a graph {in_graph * 1e3:.3f} us")
        if label == "er_100k":
            records["fault_timeline, per-edge stream"] = _record(
                "fault_timeline, per-edge stream", 0.0, ms, plain, b_ms, b_by, None,
                graph_ms=in_graph, shape=list(shape), dtype="bool")
        fm_kw = dict(kw, drop_prob=kw["edge_drop_prob"])
        del fm_kw["edge_drop_prob"]
        for dtype in (torch.float32, torch.float64):
            fm = faults.make_faulty_mixing(topo, seed=203, horizon=horizon, device=dev,
                                           x64=dtype == torch.float64, **fm_kw)
            for t in (0, 17, horizon - 1, horizon, horizon + 40):
                _slot_round_is_the_twin_s(torch, dk, fm, t, dtype, label)
        _slot_round_replicas_are_the_twin_s(torch, dk, faults, topo, horizon, fm_kw, label)
        fm = faults.make_faulty_mixing(topo, seed=203, horizon=horizon, device=dev, **fm_kw)
        _caller_liveness_is_the_twin_s(torch, np, dk, fm, topo, horizon, label)
        tt = torch.tensor([17], device=dev)
        total = torch.zeros((), dtype=torch.float64, device=dev)

        def slot():
            return dk.realize_slot_round(tt, fm._slots, fm._tl, degree_total=total)

        ms = time_ms(torch, slot)
        in_graph = graph_ms(torch, slot)
        _, live_pass, weight_pass = dk.slot_round_passes(tt, fm._slots, fm._tl,
                                                         degree_total=total)
        live_pass()
        passes = {name: (graph_ms(torch, fn), time_ms(torch, fn))
                  for name, fn in (("live", live_pass), ("weight", weight_pass))}
        plain = time_ms(torch, lambda: dk.realize_slot_round_plain(
            tt, fm._slots, fm._tl, degree_total=total), n=20)
        row_bytes = sum(x.shape[-1] for x in fm._tl if x is not None)
        live_slots = int(dk.realize_slot_round_plain(tt, fm._slots, fm._tl).live.sum())
        b_ms, b_by = slot_round_bound(fm._slots, row_bytes, 4, live_slots)
        n, k = fm._slots.nbr.shape
        apart = ", ".join(f"the {name} pass {g * 1e3:.3f} us in a graph ({e * 1e3:.3f} "
                          "event-timed)" for name, (g, e) in passes.items())
        _kernel_line("realize_slot_round", (n, k), "float32", 0.0, ms, plain, None, b_ms, b_by,
                     f" ({label}: {kw}; two launches), in a graph {in_graph * 1e3:.3f} us; "
                     f"{apart}")
        row = dict(graph_ms=in_graph, live_pass_graph_ms=passes["live"][0],
                   weight_pass_graph_ms=passes["weight"][0], live_pass_ms=passes["live"][1],
                   weight_pass_ms=passes["weight"][1], shape=[n, k], dtype="float32")
        if label == "er_100k":
            records["realize_slot_round"] = _record(
                "realize_slot_round", 0.0, ms, plain, b_ms, b_by, None, **row)
        else:
            ring_row = dict(row, ms=ms, plain_ms=plain, bound_ms=b_ms)
        del fm
    if "realize_slot_round" in records:
        records["realize_slot_round"]["ring_256"] = ring_row
    say("[kernels] the timeline's per-edge stream and realize_slot_round (live, w, w_self, "
        "active, the degree count; W in float32 and float64; t inside, at and past the "
        f"horizon) bitwise their plain versions at {', '.join(SLOT_ROWS)}")
    dense_round_past_2_32(torch, dk, pkg)
    return records


def dense_round_past_2_32(torch, dk, pkg):
    """The dense round at N = DENSE_ROUND_N on the ring, where the counter
    i·N + j passes 2³², under 20% drops and 10% stragglers: A_t and W_t (2 ×
    17.2 GB in float32) from tables built of the matrix-free ring's own
    table (no [N, N] host array), five rows bitwise the rows-only plain
    version at two counters."""
    from distributed_optimization_tpu_torch.parallel import faults

    dev = torch.device("cuda")
    n = DENSE_ROUND_N
    topo = pkg.build_topology("ring", n, impl="neighbor")
    tables = faults.round_tables(topo, device=dev)
    keys = faults._tag_keys(203, False, faults.FAULT_TAG, faults.NODE_TAG, faults.MATCH_TAG)
    rows = [0, 1, n // 2, n - 2, n - 1]
    kw = dict(drop_prob=0.2, straggler_prob=0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t in (17, 2**32 + 3):
        tt = torch.tensor([t], device=dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = dk.realize_round(tt, keys, tables, weights=torch.float32, **kw)
        end.record()
        torch.cuda.synchronize()
        got = (out.A[rows].clone(), out.W[rows].clone(), out.active[rows].clone())
        del out
        want = dk.realize_round_rows_plain(tt, keys, tables, rows, **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"realize_round at N={n} t={t}: rows not bitwise the rows-only plain version")
        say(f"[kernels] realize_round at ring N={n} (counters to {(n - 1) * n + n - 1:,} > 2^32), "
            f"t={t}: rows {rows} bitwise the rows-only plain version; one launch "
            f"{start.elapsed_time(end):.1f} ms (A_t and W_t {2 * 4 * n * n / 1e9:.1f} GB), "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.empty_cache()


def _fed_run(torch, pkg, counters, cfg, ds, f_opt, label):
    """One federated cell on the card: its graph and timeline set-up,
    warm-up and capture, graph iters/s, peak device memory and gaps.
    Returns (result, launches, the topology the run built)."""
    from distributed_optimization_tpu_torch.backends import torch_backend

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _kept(torch_backend, "build_topology") as built:
        res, launches = _converging_run(torch, pkg, counters, cfg, ds, f_opt, label,
                                        converges=False)
    peak = torch.cuda.max_memory_allocated()
    check(len(built) == 1, f"federated {label}: {len(built)} graphs built, not one")
    topo, h = built[0], res.history
    say(f"[federated] {label}: N={cfg.n_workers} {cfg.topology} "
        f"impl={cfg.resolved_topology_impl()} sampler={cfg.resolved_topology_sampler()} "
        f"k_max={int(topo.degrees.max())}: graph set-up {h.topology_setup_seconds:.3f} s, "
        f"timeline set-up "
        f"{h.fault_setup_seconds:.4f} s, warm-up and capture {h.compile_seconds:.2f} s, "
        f"{h.iters_per_second:.1f} iters/s in the graph, peak device memory "
        f"{peak / 2**20:.1f} MiB, gap at {int(h.eval_iterations[0])} {h.objective[0]:.6f}, "
        f"final gap {h.objective[-1]:.6f}, spectral gap {h.spectral_gap:.6g}"
        + (f"; 57ca189's {FEDERATED_PARENT[label]:,.1f} iters/s"
           if label in FEDERATED_PARENT else ""))
    return res, launches, topo


def _table_digest(topo) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(topo.nbr_idx).tobytes())
    h.update(np.ascontiguousarray(topo.nbr_mask).tobytes())
    return h.hexdigest()[:16]


def phase_federated(torch, np, pkg, kernels):
    """The JAX package's federated-scale cells on one card: (i)
    bench_federated.py's ER scale cells, neighbor at N = 1,024, 4,096 and
    10,000, dense below 10,000, and the N=1,024 pair in float64 within
    1e-12; (ii) er_100k_p4_sparse fault-free and under 10% iid drops with
    participation 0.5 (the table's digest the CPU build's, the floats exact,
    float64 against the CPU at T = 10 within 1e-12); (iii) ring_1m_p16.
    Returns the launches of the faulted cell (ii) run."""
    from distributed_optimization_tpu_torch.backends import torch_backend

    dk, sk, rk, bk = kernels["dk"], kernels["sk"], kernels["rk"], kernels["bk"]
    counters = [dk, sk, rk, bk]
    base = pkg.ExperimentConfig(**FEDERATED_BASE)
    d = base.n_features + 1

    # (i) the scale cells.
    for n in FEDERATED_SCALE_N:
        cell = base.replace(n_workers=n, n_samples=2 * n, topology="erdos_renyi",
                            erdos_renyi_p=12.0 / n, local_batch_size=4,
                            n_iterations=FEDERATED_TIMED_T, eval_every=FEDERATED_SCALE_T)
        ds = pkg.generate_synthetic_dataset(cell)
        _, f_opt = pkg.compute_reference_optimum(ds, cell.reg_param)
        impls = ("neighbor", "dense") if n < FEDERATED_DENSE_SKIP_N else ("neighbor",)
        gaps = {}
        for impl in impls:
            cfg = cell.replace(topology_impl=impl)
            res, launches, topo = _fed_run(torch, pkg, counters, cfg, ds, f_opt,
                                           f"scale N={n} {impl}")
            # A shard of L = 2 rows under b = 4 is the whole batch (no
            # sampler), and the gather and dense mixes are PyTorch's: no
            # kernel launches.
            check(not any(launches.values()), f"federated scale N={n} {impl}: launches {launches}")
            check(res.history.total_floats_transmitted
                  == topo.floats_per_iteration * d * cfg.n_iterations,
                  f"federated scale N={n} {impl}: floats not 2|E|·d·T")
            gaps[impl] = res.history.objective[0]
            if n == FEDERATED_SCALE_N[0] and impl == "neighbor":
                # The cell's own config (T = 100, one eval): the timed run's
                # first eval, bit for bit.
                own = cfg.replace(n_iterations=FEDERATED_SCALE_T)
                one, _ = _converging_run(torch, pkg, counters, own, ds, f_opt,
                                         f"federated scale N={n} T={FEDERATED_SCALE_T}",
                                         converges=False)
                check(np.array_equal(one.history.objective, res.history.objective[:1]),
                      "federated: the cell's T=100 gap is not the timed run's first eval")
        say(f"[federated] scale N={n}: gap at {FEDERATED_SCALE_T} "
            + ", ".join(f"{k} {v:.6f}" for k, v in gaps.items()))
        if n == FEDERATED_SCALE_N[0]:
            f64 = cell.replace(dtype="float64", n_iterations=FEDERATED_SCALE_T)
            nb = pkg.run(f64.replace(topology_impl="neighbor"), ds, f_opt, device="cuda")
            dn = pkg.run(f64.replace(topology_impl="dense"), ds, f_opt, device="cuda")
            diff = float(np.abs(nb.final_models - dn.final_models).max())
            say(f"[federated] scale N={n} float64 T={FEDERATED_SCALE_T}: neighbor against dense "
                f"final models {diff:.3e} apart, floats {nb.history.total_floats_transmitted:.0f} "
                f"and {dn.history.total_floats_transmitted:.0f}")
            check(diff <= 1e-12 and nb.history.total_floats_transmitted
                  == dn.history.total_floats_transmitted,
                  f"federated scale N={n}: neighbor and dense float64 models {diff:.3e} apart")

    # (ii) er_100k_p4_sparse, unsharded.
    cfg = base.replace(**ER_100K)
    check(cfg.resolved_topology_impl() == "neighbor" and cfg.resolved_topology_sampler()
          == "sparse", "federated er_100k: 'auto' does not resolve to neighbor + sparse")
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    res, launches, topo = _fed_run(torch, pkg, counters, cfg, ds, f_opt, "er_100k fault-free")
    digest = _table_digest(topo)
    say(f"[federated] er_100k: table digest {digest} (the JAX package's sparse build "
        f"{ER_100K_DIGEST}), E = {int(topo.degrees.sum()) // 2:,}")
    check(digest == ER_100K_DIGEST, "federated er_100k: the table differs from the CPU build's")
    check(res.history.total_floats_transmitted == topo.floats_per_iteration * d * cfg.n_iterations
          and not any(launches.values()),
          f"federated er_100k fault-free: floats or launches {launches}")
    faulted = cfg.replace(**ER_100K_FAULTS)
    with _kept(torch_backend, "make_faulty_mixing") as made:
        res, fault_launches, _ = _fed_run(torch, pkg, counters, faulted, ds, f_opt,
                                          "er_100k faulted")
    T = faulted.n_iterations
    check(_only(fault_launches, realize_slot_round=dk.SLOT_ROUND_LAUNCHES * T,
                fault_timeline=dk.TIMELINE_LAUNCHES) == fault_launches and len(made) == 1,
          f"federated er_100k faulted: launches {fault_launches}")
    # The floats: each round's live slots, counted on the host from the
    # timeline the run drew.
    tl = made[0].timeline
    ei, ej = tl.edge_index[:, 0], tl.edge_index[:, 1]
    live_edges = tl.edge_up & tl.part_up[:, ei] & tl.part_up[:, ej]
    want = 2.0 * float(live_edges.sum()) * d
    say(f"[federated] er_100k faulted: floats {res.history.total_floats_transmitted:.0f}, from "
        f"the run's timeline on the host {want:.0f}; the fault-free cell's "
        f"{topo.floats_per_iteration * d * T:.0f}")
    check(res.history.total_floats_transmitted == want,
          "federated er_100k faulted: floats not the timeline's live slots × d")
    del made
    f64 = faulted.replace(dtype="float64", n_iterations=ER_100K_F64_T,
                          eval_every=ER_100K_F64_T // 2)
    card = pkg.run(f64, ds, f_opt, device="cuda")
    host = pkg.run(f64, ds, f_opt, device="cpu")
    _agree(f"er_100k faulted float64 T={ER_100K_F64_T}", card, host, phase="federated")
    check(card.history.total_floats_transmitted == host.history.total_floats_transmitted,
          "federated er_100k float64: card and CPU floats differ")

    # (iii) ring_1m_p16, unsharded.
    cfg = base.replace(**RING_1M, n_iterations=RING_1M_TIMED_T, eval_every=RING_1M_T)
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    res, launches, topo = _fed_run(torch, pkg, counters, cfg, ds, f_opt, "ring_1m")
    check(not any(launches.values())
          and res.history.total_floats_transmitted == 2 * cfg.n_workers * d * cfg.n_iterations,
          f"federated ring_1m: launches {launches} or floats")
    own = cfg.replace(n_iterations=RING_1M_T)
    one, _ = _converging_run(torch, pkg, counters, own, ds, f_opt,
                             f"federated ring_1m T={RING_1M_T}", converges=False)
    check(np.array_equal(one.history.objective, res.history.objective[:1]),
          "federated ring_1m: the cell's T=10 gap is not the timed run's first eval")
    return fault_launches


def event_sampler_bound(L: int, b: int, d: int, itemsize: int, events: int = 1):
    """(ms, 'bytes' or 'operations') for a block of ``events`` events' draws:
    each 2 + L Threefry calls (the worker and step keys, each row's score),
    the mantissas and a top-k selection of k = min(b, L) rows (L·⌈log2 k⌉
    compares), against the cursor and n_valid read once, each event's
    worker and step, the k rows of X and y read and Xb [b, d], yb and the
    weights written."""
    k = min(b, L)
    ops = events * (THREEFRY_OPS * (2 + L) + 3 * L + L * max(1, math.ceil(math.log2(k))))
    nbytes = 16 + events * (16 + k * (d + 1) * itemsize + b * (d + 2) * itemsize)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _first_crossing(np, gaps, clocks, eps):
    hit = np.nonzero(np.asarray(gaps) <= eps)[0]
    return float(clocks[hit[0]]) if hit.size else None


def _block_draws(pkg, cfg) -> int:
    """The event sampler's launches in a run of ``cfg``: one a block of
    events."""
    events = cfg.n_workers * cfg.n_iterations
    return events // pkg.event_block(cfg.eval_every * cfg.n_workers)


def _async_run(torch, pkg, counters, cfg, ds, f_opt, label, **kw):
    """One event-clock run on the card with its launch counts, finite."""
    import numpy as np

    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    res = pkg.run_async(cfg, ds, f_opt, device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items() if v}
    h = res.history
    events_per_s = h.iters_per_second * cfg.n_workers
    say(f"[async] {label}: N={cfg.n_workers} T={cfg.n_iterations} "
        f"({cfg.n_workers * cfg.n_iterations:,} events, {cfg.dtype}"
        f"{', uncaptured' if kw.get('capture') is False else ''}): final gap "
        f"{h.objective[-1]:.6f}, floats {h.total_floats_transmitted:.0f}, "
        f"{events_per_s:,.1f} events/s ({1e6 / events_per_s:.2f} us an event), "
        f"capture {h.capture_seconds:.3f} s, warm-up and capture {h.compile_seconds:.3f} s, "
        f"whole run {wall:.2f} s, launches {launches}, gap history sha256 "
        f"{_digest(np, h.objective)}"
        + (f"; ed403b4's {ASYNC_PARENT[label]:,.1f} events/s"
           if label in ASYNC_PARENT and kw.get("capture") is not False else ""))
    check(bool(np.all(np.isfinite(h.objective))), f"async {label}: non-finite gaps")
    return res, launches


def phase_async(torch, np, pkg, kernels):
    """The asynchronous event clock on the card. (1) bench_async.py's four
    latency cells with the sync one-peer and full-gossip baselines: each
    final gap within 1% of the JAX package's (``ASYNC_REFERENCE``), floats
    exact, the bench's speedup floors and gap envelopes, and at constant
    latency the sync clock, floats and zero skew; (2) the degenerate gate
    in float64: async at constant latency against sync one-peer on shared
    batches, and card against CPU, each within 1e-12; (3)
    bench_async_faults.py's cells: churn and thinning against healthy, the
    wall-clock gate under churn, GT composed in float64 under the tracking
    bound; (4) main's shapes on the event clock (events/s, µs an event,
    capture seconds) and a short run's graph bitwise its uncaptured run.
    Returns (the event sampler's record, its launches on main's run)."""
    sk = kernels["sk"]
    counters = [kernels[k] for k in ("rk", "fk", "bk", "sk", "ck", "dk")]

    # (1) the latency cells.
    base = pkg.ExperimentConfig(**ASYNC_BENCH)
    N, T, every = base.n_workers, base.n_iterations, base.eval_every
    ds = pkg.generate_synthetic_dataset(base)
    f_opt = pkg.compute_reference_optimum(ds, base.reg_param)[1]
    peer = pkg.run(base.replace(gossip_schedule="one_peer"), ds, f_opt, device="cuda")
    full = pkg.run(base, ds, f_opt, device="cuda")
    gaps_sync = peer.history.objective
    say(f"[async] sync baselines N={N} T={T}: one-peer final gap {gaps_sync[-1]:.6f} "
        f"(floats {peer.history.total_floats_transmitted:.0f}), full gossip "
        f"{full.history.objective[-1]:.6f} (floats {full.history.total_floats_transmitted:.0f})")
    for name, (fields, ref_gap, ref_floats) in ASYNC_REFERENCE.items():
        cfg = base.replace(**fields)
        res, launches = _async_run(torch, pkg, counters, cfg, ds, f_opt, name)
        gaps = res.history.objective
        _, tl = pkg.async_timeline_for(cfg, "cuda")
        vt_async = tl.t_virtual[every * N - 1::every * N]
        vt_sync = pkg.sync_round_times(tl)[every - 1::every]
        eps = 1.3 * max(float(gaps[-1]), float(gaps_sync[-1]))
        t_async = _first_crossing(np, gaps, vt_async, eps)
        t_sync = _first_crossing(np, gaps_sync, vt_sync, eps)
        speedup = t_sync / t_async if t_async and t_sync else None
        ratio = float(gaps[-1]) / float(gaps_sync[-1])
        rel = abs(float(gaps[-1]) / ref_gap - 1.0)
        say(f"[async] {name}: final gap {gaps[-1]:.6f} against the JAX package's {ref_gap:.6f} "
            f"({rel * 100:.3f}% apart), x{ratio:.3f} sync one-peer's; virtual clock to "
            f"eps={eps:.4f}: async {t_async}, sync {t_sync}, speedup {speedup}; staleness "
            f"{pkg.staleness_histogram(tl)}, clock skew {pkg.clock_skew(tl)['rel_spread']:.4f}")
        check(rel <= ASYNC_GAP_TOLERANCE, f"async {name}: final gap {rel * 100:.3f}% from JAX's")
        check(res.history.total_floats_transmitted == ref_floats,
              f"async {name}: floats {res.history.total_floats_transmitted} not {ref_floats}")
        check(launches == {"sample_event_block": _block_draws(pkg, cfg)},
              f"async {name}: launches {launches}")
        if name in ASYNC_FLOORS:
            check(speedup is not None and speedup >= ASYNC_FLOORS[name],
                  f"async {name}: speedup {speedup} under the {ASYNC_FLOORS[name]}x floor")
        if name in ASYNC_ENVELOPES:
            check(ratio <= ASYNC_ENVELOPES[name],
                  f"async {name}: final gap x{ratio:.3f} sync's, past {ASYNC_ENVELOPES[name]}x")
        if name == "constant":
            check(np.array_equal(vt_async, vt_sync) and round(speedup, 3) == 1.0
                  and pkg.clock_skew(tl)["rel_spread"] == 0.0
                  and res.history.total_floats_transmitted
                  == peer.history.total_floats_transmitted,
                  "async constant: not the synchronous clock and one-peer floats")

    # (2) the degenerate gate, float64, shared batches.
    eq_cfg = base.replace(**ASYNC_DEGENERATE)
    eq_ds = pkg.generate_synthetic_dataset(eq_cfg)
    eq_f = pkg.compute_reference_optimum(eq_ds, eq_cfg.reg_param)[1]
    rng = np.random.default_rng(0)
    sizes = [len(s) for s in eq_ds.shard_indices]
    sync_sched = np.stack([np.stack([rng.integers(0, sizes[i], size=eq_cfg.local_batch_size)
                                     for i in range(eq_cfg.n_workers)])
                           for _ in range(eq_cfg.n_iterations)])
    a_cfg = eq_cfg.replace(execution="async")
    _, eq_tl = pkg.async_timeline_for(a_cfg, "cuda")
    async_sched = sync_sched[eq_tl.local_step, eq_tl.worker]
    r_a = pkg.run(a_cfg, eq_ds, eq_f, device="cuda", batch_schedule=async_sched)
    r_s = pkg.run(eq_cfg.replace(gossip_schedule="one_peer"), eq_ds, eq_f, device="cuda",
                  batch_schedule=sync_sched)
    r_h = pkg.run(a_cfg, eq_ds, eq_f, device="cpu", batch_schedule=async_sched)
    dev_sync = float(np.max(np.abs(r_a.final_models - r_s.final_models)))
    dev_host = max(float(np.max(np.abs(r_a.final_models - r_h.final_models))),
                   float(np.max(np.abs(r_a.history.objective - r_h.history.objective))))
    say(f"[async] degenerate gate N={eq_cfg.n_workers} T={eq_cfg.n_iterations} float64: async "
        f"at constant latency against sync one-peer on shared batches {dev_sync:.3e} apart "
        f"(floats {r_a.history.total_floats_transmitted:.0f} and "
        f"{r_s.history.total_floats_transmitted:.0f}); card against CPU {dev_host:.3e}")
    check(dev_sync <= 1e-12 and r_a.history.total_floats_transmitted
          == r_s.history.total_floats_transmitted, "async: the degenerate gate failed")
    check(dev_host <= 1e-12, "async: the card and the CPU part in float64")

    # (3) bench_async_faults.py's cells.
    fb = pkg.ExperimentConfig(**ASYNC_FAULTS_BENCH)
    f_ds = pkg.generate_synthetic_dataset(fb)
    f_f = pkg.compute_reference_optimum(f_ds, fb.reg_param)[1]
    finals = {}
    for name, fields in ASYNC_FAULT_CELLS.items():
        cfg = fb.replace(**fields)
        res, launches = _async_run(torch, pkg, counters, cfg, f_ds, f_f, f"faults {name}",
                                   return_state=name == "gt_composed")
        topo, tl = pkg.async_timeline_for(cfg, "cuda")
        _, real, _ = pkg.event_faults_for(cfg, topo, tl, device="cuda")
        fired = real.matched_fired if real is not None else tl.matched()
        per = (4.0 if cfg.algorithm == "gradient_tracking" else 2.0) * (cfg.n_features + 1)
        check(res.history.total_floats_transmitted == per * float(fired.sum()),
              f"async faults {name}: floats not the fired live exchanges")
        # The event sampler once an event; the config's fault chains drawn
        # once a run (the timeline's two launches), on the card.
        check(launches == {"sample_event_block": _block_draws(pkg, cfg),
                           **({"fault_timeline": kernels["dk"].TIMELINE_LAUNCHES}
                              if cfg.faults_active else {})},
              f"async faults {name}: launches {launches}")
        finals[name] = float(res.history.objective[-1])
        if real is not None:
            say(f"[async] faults {name}: availability {real.availability:.4f}, in-flight lost "
                f"{real.n_inflight_lost}, thinned {real.n_thinned}, degraded {real.n_degraded}")
        if name == "gt_composed":
            st = res.final_state
            residual = float(np.max(np.abs(st["y"].mean(0) - st["g_prev"].mean(0))))
            say(f"[async] faults gt_composed: tracker residual {residual:.3e} "
                f"(bound {ASYNC_TRACKING_BOUND})")
            check(residual < ASYNC_TRACKING_BOUND, "async: the tracking invariant broke")
        if name == "churn":
            churn_res, churn_tl = res, tl
    g_h, g_c, g_t = finals["healthy"], finals["churn"], finals["thinning"]
    envelope = max(g_c, g_t) / min(g_c, g_t)
    say(f"[async] faults: healthy {g_h:.4f}, churn {g_c:.4f}, thinning {g_t:.4f}, "
        f"envelope x{envelope:.3f}")
    check(g_c >= 0.8 * g_h and g_t >= 0.8 * g_h, "async faults: a faulty run beat healthy")
    check(envelope <= 2.0, f"async faults: churn and thinning {envelope:.2f}x apart")
    sync_churn = pkg.run(fb.replace(execution="sync", latency_model="constant", latency_tail=0.0,
                                    **ASYNC_FAULT_CELLS["churn"]), f_ds, f_f, device="cuda")
    gs, ga = sync_churn.history.objective, churn_res.history.objective
    f_every, f_n = fb.eval_every, fb.n_workers
    eps = 1.3 * max(float(ga[-1]), float(gs[-1]))
    t_a = _first_crossing(np, ga, churn_tl.t_virtual[f_every * f_n - 1::f_every * f_n], eps)
    t_s = _first_crossing(np, gs, pkg.sync_round_times(churn_tl)[f_every - 1::f_every], eps)
    speedup = t_s / t_a if t_a and t_s else None
    say(f"[async] faults wall clock under churn: eps {eps:.3f}, async {t_a}, sync {t_s}, "
        f"speedup {speedup}")
    check(speedup is not None and speedup >= 2.0, f"async faults: speedup {speedup} under 2x")

    # (4) main's shapes on the event clock.
    main_ds, main_f = _main_data(pkg, MAIN_SHAPE[0])
    cfg = pkg.ExperimentConfig(**ASYNC_MAIN)
    res, main_launches = _async_run(torch, pkg, counters, cfg, main_ds, main_f, "main's shapes")
    check(main_launches == {"sample_event_block": _block_draws(pkg, cfg)},
          f"async main: launches {main_launches}")
    short = cfg.replace(n_iterations=ASYNC_MAIN_UNCAPTURED)
    graph, g_launch = _async_run(torch, pkg, counters, short, main_ds, main_f,
                                 "main's shapes, graph", return_state=True)
    eager, e_launch = _async_run(torch, pkg, counters, short, main_ds, main_f,
                                 "main's shapes", return_state=True, capture=False)
    same = (np.array_equal(graph.history.objective, eager.history.objective)
            and np.array_equal(graph.history.consensus_error, eager.history.consensus_error)
            and all(np.array_equal(graph.final_state[k], eager.final_state[k])
                    for k in graph.final_state))
    say(f"[async] main's shapes T={ASYNC_MAIN_UNCAPTURED}: the graph run "
        f"{'bitwise equals' if same else 'DIFFERS from'} the same events run uncaptured")
    check(same and g_launch == e_launch, "async: the graph run is not its uncaptured run")

    # The event sampler at main's shard (L = 49, b = 16, d = 81), float32:
    # a block of main's B = 256 events (the run's first, one inside, the
    # schedule's last), and of 200 at τ = 2, bitwise its plain version and
    # the per-event launches; the block timed in a graph and event-timed,
    # beside B launches of the per-event entry.
    dev = torch.device("cuda")
    host = pkg.stack_shards(main_ds, dtype=np.dtype("float32"))
    X = torch.as_tensor(host.X, device=dev)
    y = torch.as_tensor(host.y, device=dev)
    nv = torch.as_tensor(host.n_valid, dtype=torch.int64, device=dev)
    _, tl = pkg.async_timeline_for(cfg, "cuda")
    workers = torch.as_tensor(tl.worker, dtype=torch.int64, device=dev)
    steps = torch.as_tensor(tl.local_step, dtype=torch.int64, device=dev)
    key = pkg.event_key(cfg.seed, x64=False)
    b, E = cfg.local_batch_size, len(tl.worker)
    B = pkg.event_block(cfg.eval_every * cfg.n_workers)
    cursor = torch.zeros(1, dtype=torch.int64, device=dev)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    for events, tau, first in ((B, 1, 0), (B, 1, 777), (B, 1, E - B), (200, 2, 4_000)):
        cursor.fill_(first)
        descents = None if tau == 1 else tau
        got = sk.sample_event_block(key, cursor, workers, steps, X, y, nv, b, events,
                                    descents=descents)
        want = pkg.plain_event_block(key, cursor, workers, steps, X, y, nv, b, events, descents)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"async: the block of {events} events at {first}, τ={tau}, differs from its "
              "plain version")
        for e in (0, events // 2, events - 1):
            for m in range(tau):
                one.fill_(first + e)
                single = sk.sample_event_batch(key, one, workers, steps, X, y, nv, b,
                                               None if tau == 1 else m)
                check(all(torch.equal(g[e, m], s[0]) for g, s in zip(got, single)),
                      f"async: the block's event {first + e} differs from its own launch")
    say(f"[kernels] sample_event_block (L={X.shape[1]}, b={b}, d={X.shape[2]}) float32: "
        f"blocks of {B} events at 0, 777 and {E - B} (the schedule's last) and of 200 at τ = 2 "
        "bitwise their plain versions and their events' own launches")
    cursor.fill_(777)
    out = sk.event_block_buffer(B, 1, b, X.shape[2], torch.float32, dev)

    def kernel():
        return sk.sample_event_block(key, cursor, workers, steps, X, y, nv, b, B, out=out)

    def plain():
        return pkg.plain_event_block(key, cursor, workers, steps, X, y, nv, b, B)

    cursors = [torch.full((1,), 777 + e, dtype=torch.int64, device=dev) for e in range(B)]

    def per_event():
        for c in cursors:
            sk.sample_event_batch(key, c, workers, steps, X, y, nv, b)

    ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain, n=3)
    b_ms, b_by = event_sampler_bound(X.shape[1], b, X.shape[2], 4, events=B)
    in_graph = graph_ms(torch, kernel)
    singles = graph_ms(torch, per_event, n=4)
    say(f"[kernels] sample_event_block (B={B}, L={X.shape[1]}, b={b}, d={X.shape[2]}) float32: "
        f"bitwise its plain version; in a graph of {TIMED_LAUNCHES} launches "
        f"{in_graph * 1e3:.3f} us a launch, event-timed {ms * 1e3:.3f} us, plain "
        f"{plain_ms * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us ({b_by}); its {B} events as "
        f"{B} launches of the per-event entry in a graph {singles * 1e3:.3f} us "
        f"({singles / in_graph:.1f}x)")
    record = _record("sample_event_block", 0.0, ms, plain_ms, b_ms, b_by, None,
                     graph_ms=in_graph, per_event_launches_graph_ms=singles, events=B)
    return record, main_launches


AB_MODULES = {"rk": "ring_kernels", "fk": "fc_kernels", "bk": "robust_kernels",
              "sk": "sampling_kernels", "ck": "compression_kernels", "dk": "draw_kernels"}


def _baseline_kernels(root: str) -> dict:
    """Another tree's kernel wrappers (``root``: the root of a checkout,
    such as an unpacked ``git archive`` of the parent), keyed as AB_MODULES.
    They are imported under the package's name and then set aside, so this
    tree's modules stay in place; each binds its own tree's helpers, csrc
    and build directory."""
    import importlib
    import pathlib

    root = pathlib.Path(root).resolve()
    name = "distributed_optimization_tpu_torch"

    def loaded():
        return {k: v for k, v in sys.modules.items() if k == name or k.startswith(name + ".")}

    ours = loaded()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    importlib.invalidate_caches()
    try:
        mods = {key: importlib.import_module(f"{name}.ops.{m}") for key, m in AB_MODULES.items()}
    finally:
        sys.path.remove(str(root))
        for k in loaded():
            del sys.modules[k]
        sys.modules.update(ours)
    check(all(pathlib.Path(m.__file__).resolve().is_relative_to(root) for m in mods.values()),
          f"ab: the baseline's modules were not imported from {root}")
    return mods


def ab_calls(torch, np, pkg, topology) -> dict:
    """{kernel: make}: each kernel of the ``kernels`` line (its single-run
    wrapper) at its path's input in float32, where ``make(mods)`` gives the
    zero-argument call through a set of wrapper modules keyed as AB_MODULES
    (this tree's or a baseline's). The inputs are built once, here."""
    from distributed_optimization_tpu_torch.parallel import faults

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t = torch.tensor([12_345], device=dev)
    n, d = MAIN_SHAPE
    x, g = (torch.randn((n, d), generator=gen, device=dev) for _ in range(2))
    eta = torch.tensor([0.05 / 7.0], device=dev)
    x_fc = torch.randn(FC_RECORD_SHAPE, generator=gen, device=dev)
    calls = {
        "fused_ring_dsgd_step": lambda m: lambda: m["rk"].fused_ring_dsgd_step(x, g, eta),
        "ring_mix": lambda m: lambda: m["rk"].ring_mix(x),
        "ring_neighbor_sum": lambda m: lambda: m["rk"].ring_neighbor_sum(x),
        "fc_mix": lambda m: lambda: m["fk"].fc_mix(x_fc),
        "fc_neighbor_sum": lambda m: lambda: m["fk"].fc_neighbor_sum(x_fc),
    }
    _, nbr, live, x_r = next(r for r in robust_inputs(np, topology)
                                 if r[0] == ROBUST_RECORD[0])
    live = torch.as_tensor(live, device=dev)
    x_r = torch.as_tensor(x_r, dtype=torch.float32, device=dev)
    g_r = torch.randn(x_r.shape, generator=gen, device=dev)

    def robust(m, factory, *args):
        fn = getattr(m["bk"], factory)(ROBUST_RECORD[1], 1, nbr, 0.0, device=dev)
        return lambda: fn(live, x_r, *args)

    calls["make_fused_robust_aggregator"] = lambda m: robust(m, "make_fused_robust_aggregator")
    calls["make_fused_robust_dsgd_step"] = lambda m: robust(
        m, "make_fused_robust_dsgd_step", g_r, eta)
    key = pkg.prng.fold_in(pkg.prng.key(203, x64=False), 0)
    _, n_w, L, b = SAMPLING_RECORD["sample_worker_batch_weights"]
    nv_w = sampling_n_valid(torch, n_w, L, b)
    calls["sample_worker_batch_weights"] = lambda m: lambda: m["sk"].sample_worker_batch_weights(
        key, t, nv_w, L, b, torch.float32)
    _, n_g, L_g, b_g = SAMPLING_RECORD["sample_worker_batches"]
    nv_g = sampling_n_valid(torch, n_g, L_g, b_g)
    X, y = sampling_rows(torch, n_g, L_g, torch.float32)
    calls["sample_worker_batches"] = lambda m: lambda: m["sk"].sample_worker_batches(
        key, t, X, y, nv_g, b_g)
    # The event sampler at main's shard (a tree before the event clock has
    # no sample_event_batch, and is skipped).
    X_m, y_m = sampling_rows(torch, n_w, L, torch.float32)
    e_workers = torch.arange(n_w, dtype=torch.int64, device=dev)
    e_steps = torch.full((n_w,), 12_345, dtype=torch.int64, device=dev)
    cursor = torch.tensor([7], dtype=torch.int64, device=dev)
    e_key = pkg.event_key(203, x64=False)
    calls["sample_event_batch"] = lambda m: lambda: m["sk"].sample_event_batch(
        e_key, cursor, e_workers, e_steps, X_m, y_m, nv_w, b)
    # A block of main's 256 events: one launch here; a tree before the block
    # draw (the parent's) takes the same events as 256 per-event launches.
    blk = 256
    b_workers = e_workers.repeat(2)
    b_steps = torch.arange(2 * n_w, dtype=torch.int64, device=dev) * 7 + 12_345
    b_cursors = [torch.tensor([7 + e], dtype=torch.int64, device=dev) for e in range(blk)]

    def event_block(m):
        if hasattr(m["sk"], "sample_event_block"):
            out = m["sk"].event_block_buffer(blk, 1, b, X_m.shape[2], torch.float32, dev)

            def call():
                got = m["sk"].sample_event_block(e_key, cursor, b_workers, b_steps, X_m, y_m,
                                                 nv_w, b, blk, out=out)
                return tuple(part.reshape(blk, *part.shape[2:]) for part in got)
        else:
            def call():
                got = [m["sk"].sample_event_batch(e_key, c, b_workers, b_steps, X_m, y_m, nv_w, b)
                       for c in b_cursors]
                return tuple(torch.cat(parts) for parts in zip(*got))
        call.graph_n = 4  # calls a graph: 4 blocks, or 1,024 per-event launches
        return call

    calls["sample_event_block"] = event_block
    # The slot round at the federated cell's table (ER N=100,000, k_max 38,
    # 10% drops and participation 0.5) and the ring at N=256 (bursty drops,
    # churn and participation), t inside the horizon.
    for label, (kw, horizon) in SLOT_ROWS.items():
        fm_kw = dict(kw, drop_prob=kw["edge_drop_prob"])
        del fm_kw["edge_drop_prob"]
        slot_fm = faults.make_faulty_mixing(_slot_topology(pkg, label), seed=203,
                                            horizon=horizon, device=dev, **fm_kw)
        slot_total = torch.zeros((), dtype=torch.float64, device=dev)
        t17 = torch.tensor([17], device=dev)
        calls[f"realize_slot_round, {label}"] = (
            lambda fm_, total_, t_: lambda m: lambda: m["dk"].realize_slot_round(
                t_, fm_._slots, fm_._tl, degree_total=total_))(slot_fm, slot_total, t17)
    v, memory = compression_inputs(torch, n, d, torch.float32)

    def compress(m):
        c, (operator, k) = m["ck"].compression, COMPRESSION_RECORD
        comp = c.make_compressor(operator, d, k)
        draw = c.Draw(c.tag_key(203, x64=False), t, 0)
        return lambda: m["ck"].ef_compress(comp, draw, v, memory)

    calls["compress_exchange"] = compress
    # Every screen and the runs' compression operators in float32 and
    # float64: the bfloat16 instances share these kernels' templates.
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        x_d, g_d, eta_d = x_r.to(dtype), g_r.to(dtype), eta.to(dtype)
        for rule, ct in SCREENS:
            for factory, args in (("make_fused_robust_aggregator", ()),
                                  ("make_fused_robust_dsgd_step", (g_d, eta_d))):
                def robust_d(m, factory=factory, rule=rule, ct=ct, x_d=x_d, args=args):
                    fn = getattr(m["bk"], factory)(rule, 1, nbr, ct, device=dev)
                    return lambda: fn(live, x_d, *args)

                calls[f"{factory}, {rule} tau={ct}, {dname}"] = robust_d
        v_d, memory_d = compression_inputs(torch, n, d, dtype)
        for operator, k in COMPRESSION_TIMED:
            def compress_d(m, operator=operator, k=k, v_d=v_d, memory_d=memory_d, dtype=dtype):
                c = m["ck"].compression
                comp = c.make_compressor(operator, d, k)
                draw = c.Draw(c.tag_key(203, x64=dtype == torch.float64), t, 0)
                return lambda: m["ck"].ef_compress(comp, draw, v_d, memory_d)

            calls[f"compress_exchange, {operator} k={k}, {dname}"] = compress_d
    fm = faults.make_faulty_mixing(pkg.build_topology("ring", 256), 0.2, 203,
                                   straggler_prob=0.1, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    calls["realize_round"] = lambda m: lambda: m["dk"].realize_round(
        t, fm._keys, fm._tables, drop_prob=0.2, straggler_prob=0.1, weights=torch.float32,
        degree_total=total)[:3]
    _, n_t, horizon, kw = TIMELINE_SHAPES[0]
    args, _ = faults.timeline_args(pkg.build_topology("ring", n_t), 203, device=dev, x64=False,
                                   **_timeline_kw(kw))
    # A dense graph's arguments (the per-edge stream's n_edges left out).
    args = {k: v for k, v in args.items() if not (k == "n_edges" and v is None)}
    calls["fault_timeline"] = lambda m: lambda: m["dk"].fault_timeline(
        horizon=horizon, device=dev, **args)
    n_n, d_n = NOISE_SHAPE
    x_n = torch.randn(NOISE_SHAPE, generator=gen, device=dev)
    byz = torch.as_tensor(pkg.byzantine_mask(n_n, 6, 203), dtype=torch.uint8, device=dev)
    noise_key = pkg.prng.fold_in(pkg.prng.key(203, x64=False), 0xBAD0)
    calls["large_noise"] = lambda m: lambda: m["dk"].large_noise(noise_key, t, byz, x_n, 10.0)
    return calls


def _tensors(out) -> tuple:
    """A wrapper's output as the tuple of its tensors."""
    if isinstance(out, dict):
        out = tuple(out.values())
    elif not isinstance(out, tuple):
        out = (out,)
    return tuple(o for o in out if o is not None)


def phase_ab(torch, np, pkg, kernels, topology, baseline: str):
    """Each kernel of the ``kernels`` line (``ab_calls``) against another
    tree's wrapper of the same name on the same input, in one call
    (``baseline``: see ``_baseline_kernels``): the outputs bitwise equal,
    then a launch in a graph of 200 in turns baseline, this tree, this tree,
    baseline, this tree's faster turn against the baseline's. A kernel whose
    baseline wrapper refuses this tree's call is named and not compared."""
    base = _baseline_kernels(baseline)
    ours = {key: kernels[key] for key in AB_MODULES}
    t0 = time.perf_counter()
    base["dk"]._cuda_build.build_all([m.SOURCE for m in base.values()])
    say(f"[ab] baseline {baseline}: built in parallel in {time.perf_counter() - t0:.2f} s")
    skipped = []
    for name, make in ab_calls(torch, np, pkg, topology).items():
        new = make(ours)
        try:
            old = make(base)
            want = _tensors(old())
            torch.cuda.synchronize()
        except (AttributeError, TypeError, ValueError) as e:
            skipped.append(name)
            say(f"[ab] {name}: the baseline refuses this tree's call ({type(e).__name__}: {e})")
            continue
        check(_same(torch, _tensors(new()), want), f"ab {name}: this tree differs from the baseline")
        n = getattr(new, "graph_n", TIMED_LAUNCHES)
        us = [graph_ms(torch, f, n=n) * 1e3 for f in (old, new, new, old)]
        change = min(us[1], us[2]) / min(us[0], us[3]) - 1.0
        say(f"[ab] {name} (float32 at its path's input unless named): baseline {us[0]:.3f} "
            f"{us[3]:.3f} us, "
            f"this tree {us[1]:.3f} {us[2]:.3f} us a call in a graph of {n}: "
            f"{change * 100:+.1f}% (bitwise equal)")
    say(f"[ab] not compared: {', '.join(skipped) if skipped else 'none'}")


def robust_dense_fc(torch, np, pkg, bk):
    """The dense form on the fully-connected graph (N=25 study data, sign-flip
    by 2, trimmed mean b=2, 'auto'): resolved to dense, no fused launch,
    float32 finite over T=2,000 and float64 card against CPU (T=50)."""
    cfg = pkg.ExperimentConfig(problem_type="logistic", topology="fully_connected",
                               n_iterations=2000, eval_every=10, attack="sign_flip",
                               n_byzantine=2, attack_scale=5.0, aggregation="trimmed_mean",
                               robust_b=2)
    topo = pkg.build_topology("fully_connected", cfg.n_workers)
    impl = pkg.resolve_robust_impl(cfg, topo)
    check(impl == "dense", f"robust fc: 'auto' resolved to {impl}, not dense")
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    res, launches = _converging_run(torch, pkg, [bk], cfg, ds, f_opt, "robust dense fc",
                                    converges=False)
    check(not any(launches.values()), f"robust dense fc: fused kernels launched {launches}")
    f64 = cfg.replace(dtype="float64", n_iterations=50)
    _agree("fully_connected N=25 T=50 float64 sign_flip trimmed_mean dense",
           pkg.run(f64, ds, f_opt, device="cuda"), pkg.run(f64, ds, f_opt, device="cpu"),
           phase="robust")


def _jax_gap(np, label, family, res, card):
    """The run's final float64 gap against the JAX package's
    (JAX_FINAL_GAPS) to 1e-12, rtol and atol."""
    gap, want = float(res.history.objective[-1]), JAX_FINAL_GAPS[family]
    say(f"[objectives] {label}: final gap {gap!r}, JAX package {want!r} "
        f"({gap - want:+.3e}) ({card})")
    check(abs(gap - want) <= 1e-12 * (1.0 + abs(want)),
          f"{label}: the final gap is not the JAX package's to 1e-12")


def _objective_run(torch, np, pkg, counters, cfg, ds, f_opt, label, want, card):
    """A float32 run on the card (graph) with exactly the launches ``want``,
    finite, bitwise its ``measure_timestamps=True`` run when ``want`` holds a
    ring kernel; prints its iters/s beside the card."""
    res, counted = _converging_run(torch, pkg, counters, cfg, ds, f_opt, "objectives",
                                   converges=False)
    expect = _only(counted, **want)
    check(counted == expect, f"{label}: launches {counted}, not {expect}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, f"{label}: TF32 left on after the run")
    say(f"[objectives] {label}: {res.history.iters_per_second:.1f} iters/s at eval every "
        f"{cfg.eval_every}, final gap {res.history.objective[-1]:.6g} ({card})")
    if any(name in want for name in ("fused_ring_dsgd_step", "ring_mix")):
        _graph_equals_measured(torch, np, pkg, counters, cfg, ds, f_opt, "objectives", res,
                               counted, converges=False)
    return res, counted


def objectives_huber(torch, np, pkg, counters, card):
    """Huber: D-SGD at the main path's shapes under pallas and stencil,
    float64 card against CPU and against the JAX package, then float32 at
    T = HUBER_ITERATIONS; and the exact methods' oracle gate."""
    base = pkg.ExperimentConfig(**HUBER_MAIN, eval_every=OBJECTIVE_EVAL_EVERY)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param, huber_delta=base.huber_delta)
    L = max(len(s) for s in ds.shard_indices)
    check(L == 49, f"huber: shards of {L} rows, not main's 49")
    small = base.replace(dtype="float64", n_iterations=OBJECTIVE_ITERATIONS)
    for impl in ("pallas", "stencil"):
        cfg = small.replace(mixing_impl=impl)
        res = pkg.run(cfg, ds, f_opt, device="cuda")
        label = f"huber N=256 T={cfg.n_iterations} float64 {impl}"
        _agree_close(np, "objectives", label, res, pkg.run(cfg, ds, f_opt, device="cpu"))
        _jax_gap(np, label, "huber", res, card)
    T = HUBER_ITERATIONS
    launches = None
    for impl in ("pallas", "stencil"):
        want = {"sample_worker_batch_weights": T}
        if impl == "pallas":
            want["fused_ring_dsgd_step"] = T
        _, counted = _objective_run(torch, np, pkg, counters,
                                    base.replace(n_iterations=T, mixing_impl=impl), ds, f_opt,
                                    f"huber N=256 T={T} float32 {impl}", want, card)
        launches = launches or counted
    oracle = pkg.ExperimentConfig(**HUBER_ORACLE, mixing_impl="pallas")
    ods = pkg.generate_synthetic_dataset(oracle)
    _, of = pkg.compute_reference_optimum(ods, oracle.reg_param)
    for algorithm in ("gradient_tracking", "extra", "dsgd"):
        h = pkg.run(oracle.replace(algorithm=algorithm), ods, of, device="cuda").history
        gap, spread = float(h.objective[-1]), float(h.consensus_error[-1])
        say(f"[objectives] huber oracle gate, {algorithm} full batch η=0.05 constant, "
            f"T={oracle.n_iterations} float64: gap {gap:.3e}, consensus {spread:.3e} ({card})")
        if algorithm == "dsgd":
            check(gap > 1e-3 and spread > 1e-3, "huber: D-SGD reached the oracle; it should stall")
        else:
            check(abs(gap) < 1e-9 and spread < 1e-12,
                  f"huber: {algorithm} did not pin the oracle (gap {gap:.3e}, consensus {spread:.3e})")
    return launches


def objectives_softmax(torch, np, pkg, counters, ck, card):
    """Softmax at K=10 on the study's N=25 ring: D-SGD (the gather sampler,
    pallas), GT (ring_mix at 810 columns) and CHOCO (top_k at the study's
    γ, then top_k and random_k at CHOCO_STABLE_GAMMA), float64 card against
    CPU; D-SGD's gap against the JAX package's, and float32 at T =
    SOFTMAX_ITERATIONS."""
    base = pkg.ExperimentConfig(**SOFTMAX_STUDY, mixing_impl="pallas",
                                eval_every=OBJECTIVE_EVAL_EVERY)
    ds = pkg.generate_synthetic_dataset(base)
    _, f_opt = pkg.compute_reference_optimum(ds, base.reg_param, n_classes=base.n_classes)
    L = max(len(s) for s in ds.shard_indices)
    check(base.resolved_sampling_impl("cuda", L) == "gather", f"softmax: L={L} is not gather's")
    small = base.replace(dtype="float64", n_iterations=OBJECTIVE_ITERATIONS)
    n, d_model, T = base.n_workers, 81 * base.n_classes, small.n_iterations
    runs = {
        "dsgd": (small, {"sample_worker_batches": T, "fused_ring_dsgd_step": T}),
        "gradient_tracking": (small.replace(algorithm="gradient_tracking"),
                              {"sample_worker_batches": T, "ring_mix": 2 * T}),
    }
    choco = small.replace(algorithm="choco", compression_k=SOFTMAX_TOP_K)
    for compression, gamma in (("top_k", choco.choco_gamma), ("top_k", CHOCO_STABLE_GAMMA),
                               ("random_k", CHOCO_STABLE_GAMMA)):
        runs[f"choco {compression} k={SOFTMAX_TOP_K} γ={gamma}"] = (
            choco.replace(compression=compression, choco_gamma=gamma),
            {"sample_worker_batches": T, "compress_exchange": T, "ring_mix": T})
    for name, (cfg, want) in runs.items():
        for c in counters:
            c.reset_launch_counts()
        res = pkg.run(cfg, ds, f_opt, device="cuda", return_state=True)
        counted = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        label = f"softmax K={cfg.n_classes} N={n} T={T} float64 {name} pallas"
        check(counted == _only(counted, **want), f"{label}: launches {counted}, not {want}")
        check(res.final_models.shape == (n, d_model), f"{label}: models {res.final_models.shape}")
        amplifies = cfg.compression == "top_k" and cfg.choco_gamma != CHOCO_STABLE_GAMMA
        record = []
        with _recorded_exchanges(ck, record) if amplifies else contextlib.nullcontext():
            host = pkg.run(cfg, ds, f_opt, device="cpu", return_state=True)
        if amplifies:
            _top_k_agree(np, pkg, ck, label, cfg, ds, f_opt, res, host, record, card)
        else:
            _agree_close(np, "objectives", label, res, host)
        floats = res.history.total_floats_transmitted
        payload = 2 * SOFTMAX_TOP_K if cfg.compression != "none" else d_model
        want_floats = 2 * n * payload * (2 if name == "gradient_tracking" else 1) * T
        say(f"[objectives] {label}: floats transmitted {floats:.10g} (CPU "
            f"{host.history.total_floats_transmitted:.10g}, expected {want_floats}) ({card})")
        check(floats == host.history.total_floats_transmitted == want_floats,
              f"{label}: floats transmitted {floats}, not {want_floats}")
        if name == "dsgd":
            _jax_gap(np, label, "softmax", res, card)
    T = SOFTMAX_ITERATIONS
    _, counted = _objective_run(
        torch, np, pkg, counters, base.replace(n_iterations=T), ds, f_opt,
        f"softmax K=10 N={n} T={T} float32 pallas",
        {"sample_worker_batches": T, "fused_ring_dsgd_step": T}, card)
    return counted


@contextlib.contextmanager
def _kept(module, name: str):
    """Within the block, each call of ``module.name`` keeps its result in
    the list yielded (a run's own topology or fault process, as the run
    built it)."""
    made, fn = [], getattr(module, name)

    def keep(*args, **kw):
        made.append(fn(*args, **kw))
        return made[-1]

    setattr(module, name, keep)
    try:
        yield made
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _recorded_exchanges(ck, record):
    """Record each estimate update of a run, as ``(scores |v − x̂|, the
    selection [N, d] bool, x̂⁺, bitwise its twin)`` on the host. On a card
    the selection is the kernel's own mask bits (``ef_levels``, which
    counts no launch) and the twin is the plain version on the card's own
    inputs; on the CPU both are the plain version. Calls ``.cpu()`` at
    every exchange, so a card run must be ``measure_timestamps=True``."""
    ef_compress = ck.ef_compress

    def recorded(compressor, draw, v, memory):
        out = ef_compress(compressor, draw, v, memory)
        if v.device.type == "cuda":
            mask = ck.ef_levels(compressor, draw, v, memory)[1]
            same = out.equal(ck.compression.ef_compress_plain(compressor, draw, v, memory))
        else:
            mask, same = ck.levels_plain(compressor, draw, v, memory), True
        record.append(((v - memory).abs().cpu(), mask.cpu() != 0, out.cpu(), same))
        return out

    ck.ef_compress = recorded
    try:
        yield record
    finally:
        ck.ef_compress = ef_compress


def _top_k_agree(np, pkg, ck, label, cfg, ds, f_opt, res, host, host_rec, card):
    """CHOCO top_k on the card against the CPU, exchange by exchange. At
    the study's γ = 0.3 the run amplifies rounding about tenfold every 25
    iterations without any selection differing (two CPU runs whose
    products sum in two orders part so: ``tests/test_torch_softmax.py``),
    so its final models cannot agree to 1e-12. Held instead: the gap and
    consensus histories to 1e-12 over the whole run; at every exchange of
    a measured card run (bitwise the graph run), the kernel's output
    bitwise its twin on the card's own inputs, and the kernel's selection
    the CPU's but for swaps among scores within 1e-12 of the row's k-th;
    the estimates to 1e-12 through T/2 and to ``TOP_K_DRIFT`` through T.
    ``host_rec`` is the CPU run's record (``_recorded_exchanges``)."""
    pairs = [("gap", res.history.objective, host.history.objective),
             ("consensus", res.history.consensus_error, host.history.consensus_error)]
    worst = {what: float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) for what, a, b in pairs}
    check(all(np.allclose(a, b, rtol=1e-12, atol=1e-12) for _, a, b in pairs),
          f"{label}: card and CPU histories disagree beyond 1e-12: {worst}")
    card_rec = []
    with _recorded_exchanges(ck, card_rec):
        measured = pkg.run(cfg, ds, f_opt, device="cuda", measure_timestamps=True,
                           return_state=True)
    T, k = cfg.n_iterations, cfg.compression_k
    check(len(card_rec) == len(host_rec) == T, f"{label}: {len(card_rec)} exchanges, not {T}")
    check(all(np.array_equal(measured.final_state[leaf], res.final_state[leaf])
              for leaf in ("x", "xhat")), f"{label}: the measured run is not the graph run")
    check(all(same for *_, same in card_rec),
          f"{label}: the kernel's estimate is not bitwise its twin on the card's inputs")
    swapped, parted, first = 0, [], None
    for t, ((sa, ma, xa, _), (sb, mb, xb, _)) in enumerate(zip(card_rec, host_rec), 1):
        rows = (ma != mb).any(dim=1).nonzero().flatten().tolist()
        swapped += bool(rows)
        for r in rows:
            cols = (ma[r] != mb[r]).nonzero().flatten()
            for s in (sa, sb):
                kth = float(s[r].sort(descending=True).values[k - 1])
                check(bool(((s[r, cols] - kth).abs() <= 1e-12 * (1.0 + kth)).all()),
                      f"{label}: at iteration {t}, row {r}, the card and the CPU select other "
                      f"columns ({cols.tolist()}) that do not tie the k-th score to 1e-12")
        parted.append(float(((xa - xb).abs() / (1.0 + xb.abs())).max()))
        if first is None and parted[-1] > 1e-12:
            first = t
    final = {leaf: float(np.max(np.abs(res.final_state[leaf] - host.final_state[leaf])
                                / (1.0 + np.abs(host.final_state[leaf]))))
             for leaf in ("x", "xhat")}
    say(f"[objectives] {label} on the card vs plain on the CPU: gap {worst['gap']:.3e}, "
        f"consensus {worst['consensus']:.3e}; {T} exchanges, each bitwise its twin on the "
        f"card's inputs, selections equal the CPU's at {T - swapped} (the rest part on near "
        f"ties); estimates within {max(parted[:T // 2]):.3e} through iteration {T // 2}, "
        f"first beyond 1e-12 at iteration {first}, at T models {final['x']:.3e}, xhat "
        f"{final['xhat']:.3e} ({card})")
    check(max(parted[:T // 2]) <= 1e-12 and max(parted) <= TOP_K_DRIFT,
          f"{label}: the estimates part beyond 1e-12 through iteration {T // 2} or beyond "
          f"{TOP_K_DRIFT} through {T}")


def _bench_dataset(np, pkg, n: int, b: int, d_feat: int, k: int):
    """examples/bench_compute_bound.py's _random_dataset: default_rng(0),
    standard-normal features plus a bias column, uniform labels, each
    worker's shard its batch."""
    rng = np.random.default_rng(0)
    rows = n * b
    X = rng.standard_normal((rows, d_feat)).astype(np.float64)
    X = np.hstack([X, np.ones((rows, 1))])
    y = rng.integers(0, k, size=rows).astype(np.float64)
    return pkg.HostDataset(X_full=X, y_full=y,
                           shard_indices=[np.arange(i * b, (i + 1) * b) for i in range(n)],
                           problem_type="softmax")


def _wide_ring_kernels(torch, rk, topology, card):
    """The ring kernels at the objectives' widths in float32: bitwise their
    plain versions, event-timed and in a graph, against the bytes bound and
    the dense product with W (the library yardstick)."""
    k = COMPUTE_BOUND["n_classes"]
    shapes = [("ring_mix", 25, 810), ("fused_ring_dsgd_step", 25, 810)]
    shapes += [("fused_ring_dsgd_step", 8, (d + 1) * k) for d in COMPUTE_BOUND_FEATURES]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for name, n, d in shapes:
        x = torch.randn((n, d), generator=gen, device="cuda")
        g = torch.randn((n, d), generator=gen, device="cuda")
        eta = torch.tensor([0.05 / 7.0], device="cuda")
        W, A, _ = ring_matrices(torch, topology, n, torch.float32)
        kernel, plain, library = _ring_calls(torch, rk, name, x, g, eta, W, A)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} [{n}, {d}]: not bitwise its plain version")
        launches = 50 if d > 1_000_000 else TIMED_LAUNCHES
        ms, in_graph = time_ms(torch, kernel, launches), graph_ms(torch, kernel, launches)
        plain_ms, lib_ms = time_ms(torch, plain, launches), time_ms(torch, library, launches)
        b_ms, b_by = bound(name, n, d, "float32", 4)
        say(f"[objectives] {name} [{n}, {d}] float32: in a graph {in_graph * 1e3:.3f} us, "
            f"event-timed {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, library (dense W) "
            f"{lib_ms * 1e3:.3f} us, bound {b_ms * 1e3:.3f} us ({b_by}), bound/in-graph "
            f"{b_ms / in_graph:.1%} ({card})")
        del x, g, got, want
    torch.cuda.empty_cache()


def _wide_compression(torch, ck, card):
    """The compression kernel at CHOCO's softmax row (top_k 81 of 810, the
    block-a-row path) in float32: bitwise its twin, timed, against its
    bound."""
    compression = ck.compression
    n, d, k = 25, 810, SOFTMAX_TOP_K
    v, memory = compression_inputs(torch, n, d, torch.float32)
    t = torch.full((1,), 12_345, dtype=torch.int64, device="cuda")
    draw = compression.Draw(compression.tag_key(203, x64=False), t, 0)
    comp = compression.make_compressor("top_k", d, k)
    err, _, _ = _check_compression(torch, ck, comp, draw, v, memory, f"top_k [{n}, {d}]")
    kernel = lambda: ck.ef_compress(comp, draw, v, memory)  # noqa: E731
    plain = lambda: compression.ef_compress_plain(comp, draw, v, memory)  # noqa: E731
    ms, in_graph, plain_ms = time_ms(torch, kernel), graph_ms(torch, kernel), time_ms(torch, plain)
    topk_ms = graph_ms(torch, lambda: torch.topk((v - memory).abs(), k, dim=-1))
    b_ms, b_by = compression_bound("top_k", n, d, k, 4)
    say(f"[objectives] compress_exchange[top_k k={k}] [{n}, {d}] float32: max_abs_err {err:.3e}, "
        f"in a graph {in_graph * 1e3:.3f} us, event-timed {ms * 1e3:.3f} us, plain "
        f"{plain_ms * 1e3:.3f} us, torch.topk of the scores in a graph {topk_ms * 1e3:.3f} us, "
        f"bound {b_ms * 1e3:.4f} us ({b_by}) ({card})")


def objectives_compute_bound(torch, np, pkg, counters, card):
    """The compute-bound cells: finite and decreasing over T (metrics on),
    then timed with metrics off as the bench times them; TFLOP/s from
    4·N·b·d·K against the FP32 (highest) or dense TF32 (default) peak; at d
    = 4,096 the float32 runs against a float64 CPU run of a few
    iterations."""
    n, b, k = COMPUTE_BOUND["n_workers"], COMPUTE_BOUND["local_batch_size"], COMPUTE_BOUND["n_classes"]
    T, every = COMPUTE_BOUND_ITERATIONS, COMPUTE_BOUND_EVAL_EVERY
    for d_feat in COMPUTE_BOUND_FEATURES:
        ds = _bench_dataset(np, pkg, n, b, d_feat, k)
        d = d_feat + 1
        flops = 4.0 * n * b * d * k
        base = pkg.ExperimentConfig(**COMPUTE_BOUND, n_samples=n * b, n_features=d_feat,
                                    n_iterations=T, eval_every=every)
        for precision, impl in itertools.product(("highest", "default"), ("stencil", "pallas")):
            cfg = base.replace(matmul_precision=precision, mixing_impl=impl)
            label = f"compute-bound d={d_feat} K={k} {precision} {impl}"
            for c in counters:
                c.reset_launch_counts()
            h = pkg.run(cfg, ds, 0.0, device="cuda").history
            counted = {name: v for c in counters for name, v in c.LAUNCHES.items()}
            want = _only(counted, **({"fused_ring_dsgd_step": T} if impl == "pallas" else {}))
            check(counted == want, f"{label}: launches {counted}, not {want}")
            check(torch.backends.cuda.matmul.allow_tf32 is False, f"{label}: TF32 left on")
            check(bool(np.all(np.isfinite(h.objective))) and h.objective[-1] < h.objective[0],
                  f"{label}: the objective {h.objective} is not finite and decreasing")
            timed = pkg.run(cfg, ds, 0.0, device="cuda", collect_metrics=False).history
            ips = timed.iters_per_second
            peak = PEAK_FLOPS["float32"] if precision == "highest" else PEAK_TF32_FLOPS
            say(f"[objectives] {label}: objective {h.objective[0]:.6f} -> {h.objective[-1]:.6f} "
                f"over T={T}; metrics off {ips:.2f} iters/s = {flops * ips / 1e12:.2f} TFLOP/s "
                f"({flops / 1e9:.1f} GFLOP an iteration), {flops * ips / peak:.1%} of the "
                f"{'FP32' if precision == 'highest' else 'dense TF32'} peak "
                f"{peak / 1e12:.0f} TFLOP/s; metrics on {h.iters_per_second:.2f} iters/s; "
                f"warm-up and capture {timed.compile_seconds:.2f} s ({card})")
        if d_feat == COMPUTE_BOUND_FEATURES[0]:
            _compute_bound_precision(torch, np, pkg, base, ds, card)
        del ds
        torch.cuda.empty_cache()


def _compute_bound_precision(torch, np, pkg, base, ds, card):
    """float32 'highest' and 'default' on the card against float64 on the
    CPU, COMPUTE_BOUND_CHECK_ITERATIONS iterations at every eval."""
    cfg = base.replace(n_iterations=COMPUTE_BOUND_CHECK_ITERATIONS, eval_every=1,
                       mixing_impl="pallas")
    t0 = time.perf_counter()
    host = pkg.run(cfg.replace(dtype="float64"), ds, 0.0, device="cpu")
    host_s = time.perf_counter() - t0
    errs = {}
    for precision in ("highest", "default"):
        got = pkg.run(cfg.replace(matmul_precision=precision), ds, 0.0, device="cuda")
        check(torch.backends.cuda.matmul.allow_tf32 is False, f"{precision}: TF32 left on")
        gap = float(np.max(np.abs(got.history.objective - host.history.objective)
                           / (1.0 + np.abs(host.history.objective))))
        models = float(np.max(np.abs(got.final_models - host.final_models))
                       / np.max(np.abs(host.final_models)))
        errs[precision] = (gap, models)
        say(f"[objectives] compute-bound d={cfg.n_features} T={cfg.n_iterations} float32 "
            f"{precision} vs float64 on the CPU ({host_s:.1f} s there): gap {gap:.3e}, models "
            f"{models:.3e} of the largest |x| ({card})")
    gap, models = errs["highest"]
    check(gap <= COMPUTE_BOUND_TOL["gap"] and models <= COMPUTE_BOUND_TOL["models"],
          f"compute-bound 'highest' float32 is {gap:.3e} / {models:.3e} from float64, beyond "
          f"{COMPUTE_BOUND_TOL}")
    check(errs["default"][1] > 4 * models,
          f"'default' (TF32) is no farther from float64 than 'highest': {errs}")


def phase_objectives(torch, np, pkg, kernels, topology, card):
    """Huber and softmax on the card (see the module docstring); returns
    the launches of the Huber pallas D-SGD run and the softmax GT run."""
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on for float32 matmuls")
    counters = [kernels[k] for k in ("rk", "fk", "bk", "sk", "ck")]
    huber = objectives_huber(torch, np, pkg, counters, card)
    softmax = objectives_softmax(torch, np, pkg, counters, kernels["ck"], card)
    _wide_ring_kernels(torch, kernels["rk"], topology, card)
    _wide_compression(torch, kernels["ck"], card)
    objectives_compute_bound(torch, np, pkg, counters, card)
    return huber, softmax


# --- bfloat16 ---------------------------------------------------------------


def _bf16_ulp(torch, v):
    """A bfloat16 ulp of each |v|, in float32."""
    a = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _bf16_bound(name: str, n: int, d: int):
    """The ring and fc kernels in bfloat16: 2-byte elements read and written
    once; the operations are float32's (each computed in float32)."""
    arrays = 3 if name == "fused_ring_dsgd_step" else 2
    nbytes = arrays * n * d * 2 + (2 if name == "fused_ring_dsgd_step" else 0)
    return _bound(nbytes, OPS_PER_ELEMENT[name] * n * d, "float32")


def bf16_kernel_records(torch, np, rk, fk, sk, sampling, prng, topology, card):
    """Every bfloat16 kernel instance against its twin on the card: ring
    bitwise at main's shape and the compute-bound widths, fc bitwise the
    mirror of its order and within a bfloat16 ulp of the twin (the elements
    that differ counted), both samplers bitwise (indices, weights, rows,
    int32 labels; the weights the float32 draw's cast); each timed in a
    graph and event-timed beside its plain version, the library call in
    bfloat16 and the bound of 2-byte elements. Returns the records."""
    bf16 = torch.bfloat16
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(31)
    k = COMPUTE_BOUND["n_classes"]
    for n, d in (MAIN_SHAPE, *((8, (f + 1) * k) for f in COMPUTE_BOUND_FEATURES)):
        x = torch.randn((n, d), generator=gen, device="cuda").to(bf16)
        g = (30 * torch.randn((n, d), generator=gen, device="cuda")).to(bf16)
        eta = torch.tensor([0.05 / 7.0], device="cuda").to(bf16)
        W, A, form = ring_matrices(torch, topology, n, bf16)
        launches = 50 if d > 1_000_000 else TIMED_LAUNCHES
        for name in rk.KERNELS:
            if (n, d) != MAIN_SHAPE and name != "fused_ring_dsgd_step":
                continue
            kernel, plain, library = _ring_calls(torch, rk, name, x, g, eta, W, A)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(got.dtype == bf16 and torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"{name} [{n}, {d}] bfloat16: not bitwise its plain version ({err:.3e})")
            ms, in_graph = time_ms(torch, kernel, launches), graph_ms(torch, kernel, launches)
            plain_ms, lib_ms = time_ms(torch, plain, launches), time_ms(torch, library, launches)
            b_ms, b_by = _bf16_bound(name, n, d)
            say(f"[bfloat16] {name:22s} [{n}, {d}] bitwise its plain version: in a graph "
                f"{in_graph * 1e3:.3f} us, event-timed {ms * 1e3:.3f} us, plain "
                f"{plain_ms * 1e3:.3f} us, library ({form} W, bfloat16) {lib_ms * 1e3:.3f} us, "
                f"bound {b_ms * 1e3:.4f} us ({b_by}), bound/in-graph {b_ms / in_graph:.1%} ({card})")
            if (n, d) == MAIN_SHAPE:
                records[f"{name}, bfloat16"] = _record(f"{name}, bfloat16", err, ms, plain_ms,
                                                       b_ms, b_by, lib_ms, graph_ms=in_graph)
            else:
                records[f"{name}, bfloat16"].setdefault("wide", {})[f"8x{d}"] = {
                    "graph_ms": in_graph, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms}
        del x, g, W, A
    torch.cuda.empty_cache()
    for n, d in ((25, 81), MAIN_SHAPE, (4096, 1024)):
        x = (4 * torch.randn((n, d), generator=gen, device="cuda")).to(bf16)
        for name in fk.KERNELS:
            kernel, plain, library = _fc_calls(torch, fk, name, x)
            plan = fk.plan_for(name, x)
            got, want, mirror = kernel(), plain(), fk.MIRRORS[name](x, plan)
            torch.cuda.synchronize()
            check(torch.equal(got, mirror), f"{name} [{n}, {d}] bfloat16: not bitwise the "
                                            f"mirror of its order ({plan.describe()})")
            total = x.float().sum(0, keepdim=True).expand_as(x)
            tol = (_bf16_ulp(torch, got) if name == "fc_mix"
                   else _bf16_ulp(torch, total) + _bf16_ulp(torch, got))
            diff = (got.float() - want.float()).abs()
            err, parted = float(diff.max()), int((diff > 0).sum())
            check(bool((diff <= tol).all()), f"{name} [{n}, {d}] bfloat16: beyond a bfloat16 ulp "
                                             f"of the twin ({err:.3e})")
            ms, in_graph = time_ms(torch, kernel), graph_ms(torch, kernel)
            plain_ms, lib_ms = time_ms(torch, plain), time_ms(torch, library)
            b_ms, b_by = _bf16_bound(name, n, d)
            say(f"[bfloat16] {name:22s} [{n}, {d}] bitwise the mirror; against the twin "
                f"{parted} of {n * d} elements differ, by at most {err:.3e} (within a bfloat16 "
                f"ulp); in a graph {in_graph * 1e3:.3f} us, event-timed {ms * 1e3:.3f} us, plain "
                f"{plain_ms * 1e3:.3f} us, library ({'torch.mean' if name == 'fc_mix' else 'torch.sum'}"
                f", bfloat16) {lib_ms * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us ({b_by}); plan "
                f"{plan.describe()} ({card})")
            if (n, d) == FC_RECORD_SHAPE:
                records[f"{name}, bfloat16"] = _record(f"{name}, bfloat16", err, ms, plain_ms,
                                                       b_ms, b_by, lib_ms, graph_ms=in_graph,
                                                       parted=parted)
        del x
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    checked = 0
    for label, n, L, b in SAMPLING_SHAPES:
        nv = sampling_n_valid(torch, n, L, b)
        X, _ = sampling_rows(torch, n, L, bf16)
        labels = torch.randint(0, k, (n, L), generator=gen, device="cuda", dtype=torch.int32)
        for seed in SAMPLING_SEEDS["float32"]:
            key = prng.fold_in(prng.key(seed, x64=False), 0)
            for counter in SAMPLING_COUNTERS:
                t.fill_(counter)
                what = f"{label} N={n} L={L} b={b} bfloat16 seed={seed} t={counter}"
                w = sk.sample_worker_batch_weights(key, t, nv, L, b, bf16)
                check(torch.equal(w, sampling.sample_worker_batch_weights(key, t, nv, L, b, bf16))
                      and torch.equal(w, sk.sample_worker_batch_weights(
                          key, t, nv, L, b, torch.float32).to(bf16)),
                      f"bfloat16 weights {what}: not bitwise the twin's and the float32 draw's")
                want = sampling.sample_batch_indices(key, t, nv, L, b, bf16)
                check(_same(torch, sk.sample_batch_indices(key, t, nv, L, b, bf16), want),
                      f"bfloat16 indices {what}: not bitwise")
                got = sk.sample_worker_batches(key, t, X, labels, nv, b)
                check(got[1].dtype == torch.int32
                      and _same(torch, got, (*sampling.gather_batches(X, labels, want[0]), want[1])),
                      f"bfloat16 batches {what}: not bitwise (rows, int32 labels, weights)")
                checked += 1
    say(f"[bfloat16] both samplers bitwise the twin at {checked} inputs ({len(SAMPLING_SHAPES)} "
        f"shapes, ragged shards, seeds {SAMPLING_SEEDS['float32']}, t {SAMPLING_COUNTERS}): "
        f"float32 selection, weights the float32 draw's cast, bfloat16 rows and int32 labels")
    key = prng.fold_in(prng.key(203, x64=False), 0)
    t.fill_(12_345)
    for name, (label, n, L, b) in SAMPLING_RECORD.items():
        nv = sampling_n_valid(torch, n, L, b)
        X, _ = sampling_rows(torch, n, L, bf16)
        labels = torch.randint(0, k, (n, L), generator=gen, device="cuda", dtype=torch.int32)
        if name == "sample_worker_batch_weights":
            kernel = lambda: sk.sample_worker_batch_weights(key, t, nv, L, b, bf16)  # noqa: E731
            plain = lambda: sampling.sample_worker_batch_weights(key, t, nv, L, b, bf16)  # noqa: E731
            moved = n * L * 2
        else:
            kernel = lambda: sk.sample_worker_batches(key, t, X, labels, nv, b)  # noqa: E731
            plain = lambda: sampling.sample_worker_batches(key, t, X, labels, nv, b)  # noqa: E731
            kk = min(b, L)
            moved = n * kk * (SAMPLING_D * 2 + 4) + n * b * (SAMPLING_D * 2 + 4 + 2)
        got, want = kernel(), plain()
        got, want = ((got,), (want,)) if isinstance(got, torch.Tensor) else (got, want)
        check(_same(torch, got, want), f"bfloat16 {name}: not bitwise at its timed input")
        ms, in_graph, plain_ms = time_ms(torch, kernel), graph_ms(torch, kernel), time_ms(torch, plain)
        b_ms, b_by = sampling_bound(name, n, L, b, 2)
        t_bytes = (8 + 8 * n + moved) / PEAK_BYTES_PER_S * 1e3
        if t_bytes > b_ms:
            b_ms, b_by = t_bytes, "bytes"
        say(f"[bfloat16] {name:22s} {label} N={n} L={L} b={b}: in a graph {in_graph * 1e3:.3f} us, "
            f"event-timed {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound "
            f"{b_ms * 1e3:.4f} us ({b_by}) ({card})")
        records[f"{name}, bfloat16"] = _record(f"{name}, bfloat16", 0.0, ms, plain_ms, b_ms, b_by,
                                               None, graph_ms=in_graph)
    return records


def _bf16_card_vs_cpu(torch, np, pkg, cfg, ds, f_opt, label):
    """``cfg`` in bfloat16 at BF16_CPU_ITERATIONS, an eval every 10, on the
    card and through the port on the CPU: the gap within BF16_GAP_ULPS
    bfloat16 ulps of f(x̄) at every eval; the models' difference printed."""
    cfg = cfg.replace(dtype="bfloat16", n_iterations=BF16_CPU_ITERATIONS, eval_every=10)
    card_run = pkg.run(cfg, ds, f_opt, device="cuda")
    t0 = time.perf_counter()
    host = pkg.run(cfg, ds, f_opt, device="cpu")
    host_s = time.perf_counter() - t0
    f_star = float(torch.tensor(f_opt, dtype=torch.float64).to(torch.bfloat16))
    fx = np.abs(host.history.objective + f_star)
    ulps = np.abs(card_run.history.objective - host.history.objective) / np.exp2(
        np.floor(np.log2(np.maximum(fx, 2.0 ** -126))) - 7)
    models = float(np.max(np.abs(card_run.final_models - host.final_models))
                   / np.max(np.abs(host.final_models)))
    say(f"[bfloat16] {label} T={cfg.n_iterations}, eval every 10, card vs the port's CPU run "
        f"({host_s:.1f} s there): gap {float(ulps.max()):.1f} bfloat16 ulps of f(x) at most "
        f"({int(np.sum(ulps > 0))} of {ulps.size} evals differ), models "
        f"{'bitwise' if np.array_equal(card_run.final_models, host.final_models) else f'{models:.3e} of the largest |x|'}")
    check(bool(np.all(ulps <= BF16_GAP_ULPS)),
          f"bfloat16 {label} card vs CPU: the gap parts by {float(ulps.max()):.1f} ulps, beyond "
          f"{BF16_GAP_ULPS}")


def bf16_robust_records(torch, np, bk, topology, card):
    """The robust kernels' bfloat16 instance against its twin at the kernels
    phase's four inputs, every screen, aggregator and D-SGD step: the count
    rules bitwise; clipping within a bfloat16 ulp of the twin (plus float32's
    clipping tolerance: the norms sum in another float32 order) and its step
    exactly bf16(agg) − bf16(η·g) of its own aggregate. At the ring and the
    ER table (the paths' inputs) each is timed in a graph of 200 and
    event-timed beside its plain version, the float32 instance in a graph on
    the same values, and the bound of 2-byte elements at the float32 rate. Returns the records (ring, trimmed_mean), with the ER N=64
    table's times."""
    bf16 = torch.bfloat16
    records, er_rows = {}, {}
    for label, nbr_np, live_np, x_np in robust_inputs(np, topology):
        n, k = nbr_np.shape
        d = x_np.shape[1]
        live = torch.as_tensor(live_np, device="cuda")
        nbr64 = torch.as_tensor(nbr_np, dtype=torch.int64, device="cuda")
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda").to(bf16)
        x32 = x.float()
        tol32 = _robust_tol32(torch, x32, live, nbr64)
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        g = (30 * torch.randn(x.shape, generator=gen, device="cuda")).to(bf16)
        eta = torch.tensor([0.05 / 7.0], device="cuda").to(bf16)
        g32, eta32 = g.float(), eta.float()
        for rule, ct in SCREENS:
            adaptive = rule == "clipped_gossip" and ct == 0.0
            tau = torch.tensor([ct], dtype=torch.float32, device="cuda")
            agg = bk.make_fused_robust_aggregator(rule, 1, nbr_np, ct, device="cuda")
            step = bk.make_fused_robust_dsgd_step(rule, 1, nbr_np, ct, device="cuda")
            variants = (
                ("make_fused_robust_aggregator", lambda: agg(live, x), lambda: agg(live, x32),
                 lambda: bk.fused_robust_plain(rule, 1, nbr64, live, x, tau, adaptive=adaptive),
                 False),
                ("make_fused_robust_dsgd_step", lambda: step(live, x, g, eta),
                 lambda: step(live, x32, g32, eta32),
                 lambda: bk.fused_robust_plain(rule, 1, nbr64, live, x, tau, adaptive=adaptive,
                                               g=g, eta=eta), True),
            )
            for name, kernel, kernel32, plain, with_sgd in variants:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                what = f"{name} {rule} tau={ct} {label} bfloat16"
                check(got.dtype == bf16, f"{what}: not bfloat16")
                err = float(torch.nan_to_num((got.float() - want.float()).abs()).max())
                parted = int((got.view(torch.int16) != want.view(torch.int16)).sum())
                if rule in ("trimmed_mean", "median"):
                    check(_nan_equal(torch, got, want), f"{what}: not bitwise its twin ({err:.3e})")
                else:
                    tol = _bf16_ulp(torch, want) + tol32
                    if with_sgd:
                        own = agg(live, x) - eta * g
                        check(torch.equal(got.view(torch.int16), own.view(torch.int16)),
                              f"{what}: not bf16(agg) - bf16(eta g) of its own aggregate")
                        tol = tol + _bf16_ulp(torch, agg(live, x))
                    check(bool(torch.all((got.float() - want.float()).abs() <= tol)),
                          f"{what}: beyond a bfloat16 ulp of its twin ({err:.3e})")
                if label not in ("ring", "er64"):  # the stress tables: checked, not timed
                    continue
                ms, in_graph = time_ms(torch, kernel), graph_ms(torch, kernel)
                plain_ms, f32_graph = time_ms(torch, plain), graph_ms(torch, kernel32)
                b_ms, b_by = robust_bound(rule, n, d, k, "float32", 2, with_sgd)
                say(f"[bfloat16] {name[10:]} {rule[:8]} tau={ct} {label:8s} N={n} d={d} k={k}: "
                    f"{'bitwise' if parted == 0 else f'{parted} elements within an ulp of'} its "
                    f"twin; in a graph {in_graph * 1e3:.3f} us (float32 {f32_graph * 1e3:.3f} us), "
                    f"event-timed {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound "
                    f"{b_ms * 1e3:.4f} us ({b_by}) ({card})")
                if (label, rule, ct) == (*ROBUST_RECORD, 0.0):
                    records[f"{name}, bfloat16"] = _record(
                        f"{name}, bfloat16", err, ms, plain_ms, b_ms, b_by, None,
                        graph_ms=in_graph, float32_graph_ms=f32_graph)
                if (label, rule, ct) == ("er64", ROBUST_RECORD[1], 0.0):
                    er_rows[f"{name}, bfloat16"] = dict(
                        er64_graph_ms=in_graph, er64_ms=ms, er64_plain_ms=plain_ms,
                        er64_bound_ms=b_ms, er64_float32_graph_ms=f32_graph)
    for name, extra in er_rows.items():
        records[name].update(extra)
    return records


def bf16_compression_records(torch, ck, card):
    """The compression kernel's bfloat16 instance bitwise its twin (memory⁺
    and the mask bits or qsgd levels) at every shape and operator of the
    compression phase, seeds past 2³¹, t past 2³², rounds 0 and 1; then
    the runs' operators at main's shape timed in a graph and event-timed
    beside the plain version and the float32 instance. Returns the record
    of COMPRESSION_RECORD."""
    compression = ck.compression
    bf16 = torch.bfloat16
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    checked = 0
    for n, d in COMPRESSION_SHAPES:
        v, memory = compression_inputs(torch, n, d, torch.float32)
        v, memory = (4 * v).to(bf16), memory.to(bf16)
        for name, k in COMPRESSION_OPERATORS:
            comp = compression.make_compressor(name, d, d if k is None else k)
            draws = ([(seed, counter, rnd) for seed in BF16_LAYER_SEEDS
                      for counter in BF16_LAYER_COUNTERS for rnd in COMPRESSION_ROUNDS]
                     if name != "top_k" else [(0, 0, 0)])
            for seed, counter, rnd in draws:
                t.fill_(counter)
                draw = compression.Draw(compression.tag_key(seed, x64=False), t, rnd)
                got = ck.ef_compress(comp, draw, v, memory)
                out, levels = ck.ef_levels(comp, draw, v, memory)
                want = compression.ef_compress_plain(comp, draw, v, memory)
                check(got.dtype == bf16 and torch.equal(got.view(torch.int16), want.view(torch.int16))
                      and torch.equal(out.view(torch.int16), got.view(torch.int16))
                      and torch.equal(levels, ck.levels_plain(comp, draw, v, memory)),
                      f"compression bfloat16 {name} k={comp.k} N={n} d={d} seed={seed} "
                      f"t={counter} round={rnd}: not bitwise its twin")
                checked += 1
    say(f"[bfloat16] compression kernel bitwise its twin at {checked} inputs "
        f"({len(COMPRESSION_SHAPES)} shapes, {len(COMPRESSION_OPERATORS)} operators, seeds "
        f"{BF16_LAYER_SEEDS}, t {BF16_LAYER_COUNTERS}, rounds {COMPRESSION_ROUNDS}; memory⁺, "
        f"mask bits and qsgd levels)")
    n, d = MAIN_SHAPE
    v, memory = compression_inputs(torch, n, d, torch.float32)
    v, memory = (4 * v).to(bf16), memory.to(bf16)
    v32, memory32 = v.float(), memory.float()
    t.fill_(12_345)
    draw = compression.Draw(compression.tag_key(203, x64=False), t, 0)
    record = None
    for name, k in COMPRESSION_TIMED:
        comp = compression.make_compressor(name, d, k)
        kernel = lambda: ck.ef_compress(comp, draw, v, memory)  # noqa: E731
        kernel32 = lambda: ck.ef_compress(comp, draw, v32, memory32)  # noqa: E731
        plain = lambda: compression.ef_compress_plain(comp, draw, v, memory)  # noqa: E731
        got, want = kernel(), plain()
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"compression bfloat16 {name} timed input: not bitwise")
        ms, in_graph = time_ms(torch, kernel), graph_ms(torch, kernel)
        plain_ms, f32_graph = time_ms(torch, plain), graph_ms(torch, kernel32)
        b_ms, b_by = compression_bound(name, n, d, k, 2)
        say(f"[bfloat16] compress_exchange[{name} k={k}] N={n} d={d}: in a graph "
            f"{in_graph * 1e3:.3f} us (float32 {f32_graph * 1e3:.3f} us), event-timed "
            f"{ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us "
            f"({b_by}) ({card})")
        if (name, k) == COMPRESSION_RECORD:
            record = _record("compress_exchange, bfloat16", 0.0, ms, plain_ms, b_ms, b_by, None,
                             graph_ms=in_graph, float32_graph_ms=f32_graph)
    return record


def bf16_layer_runs(torch, np, pkg, counters, card, count):
    """The robust cell's fused trimmed mean under 10% edge drops (D-SGD, and
    GT for the aggregator) and choco_randk27 on main's data, in bfloat16
    beside float32 with their launches counted exactly, and the card
    against the port's CPU run of each at BF16_CPU_ITERATIONS: the gap
    within BF16_GAP_ULPS bfloat16 ulps of f(x̄) at every eval."""
    T = BF16_LAYER_ITERATIONS
    attack = dict(attack="sign_flip", n_byzantine=12, attack_scale=5.0)
    robust = robust_config(pkg, T).replace(**attack, aggregation="trimmed_mean", robust_b=1,
                                           robust_impl="fused", edge_drop_prob=ROBUST_EDGE_DROP)
    rds = pkg.generate_synthetic_dataset(robust)
    _, r_opt = pkg.compute_reference_optimum(rds, robust.reg_param)
    choco = pkg.ExperimentConfig(problem_type="logistic", topology="ring", n_workers=256,
                                 eval_every=1, n_iterations=T, mixing_impl="pallas",
                                 **COMPRESSION_RUNS["choco_randk27"][0])
    cds = pkg.generate_synthetic_dataset(choco)
    _, c_opt = pkg.compute_reference_optimum(cds, choco.reg_param)
    gt = robust.replace(algorithm="gradient_tracking", n_iterations=BF16_SHORT_ITERATIONS)
    # (label, config, data, f*, launches, the kernel it counts, whether the
    # gap must decrease: GT's tracked gradient is not screened, and under
    # the attack its gap grows in float32 as in bfloat16, as in the robust
    # phase's GT run).
    cells = (
        ("robust edges10 trimmed_mean fused", robust, rds, r_opt,
         {"make_fused_robust_dsgd_step": T, "realize_round": T}, "make_fused_robust_dsgd_step",
         True),
        ("robust edges10 GT trimmed_mean fused", gt, rds, r_opt,
         {"make_fused_robust_aggregator": 2 * gt.n_iterations, "realize_round": gt.n_iterations},
         "make_fused_robust_aggregator", False),
        ("choco_randk27", choco, cds, c_opt, {"compress_exchange": T, "ring_mix": T,
                                              "sample_worker_batch_weights": T},
         "compress_exchange", True),
    )
    for label, cfg, data, opt, want, name, decreases in cells:
        ips = {}
        for dtype in ("float32", "bfloat16"):
            run = _bf16_run if decreases else functools.partial(_converging_run, converges=False)
            res, launches = run(torch, pkg, counters, cfg.replace(dtype=dtype), data, opt,
                                f"bfloat16: {label} {dtype}")
            ips[dtype] = res.history.iters_per_second
            got = {key: launches[key] for key in want}
            check(got == want, f"bfloat16 {label} {dtype}: launches {got}, not {want}")
        h = res.history
        say(f"[bfloat16] {label} T={cfg.n_iterations}: {ips['bfloat16']:.1f} iters/s (float32 "
            f"{ips['float32']:.1f}), final gap {h.objective[-1]:.6f} ({card})")
        count(name, launches, f"bfloat16: {label}, N=256, bfloat16, T={cfg.n_iterations}")
        _bf16_card_vs_cpu(torch, np, pkg, cfg, data, opt, label)


def _bf16_run(torch, pkg, counters, cfg, ds, f_opt, label):
    """One bfloat16 (or float32) run on the card with its launch counts:
    finite, decreasing; iters/s, the final gap and the iteration at ε."""
    res, launches = _converging_run(torch, pkg, counters, cfg, ds, f_opt, label,
                                    converges=False)
    h = res.history
    check(h.objective[-1] < h.objective[0], f"{label}: the gap did not decrease ({h.objective})")
    return res, launches


def phase_bfloat16(torch, np, pkg, kernels, topology, sampling, prng, card):
    """bfloat16 on the card: the kernels' instances against their twins,
    main's config beside float32, the card against the port's CPU run, main's
    shapes under faults, the kernels' short runs and the compute-bound
    cells. Returns (records, counted, paths)."""
    rk, fk, sk, dk = kernels["rk"], kernels["fk"], kernels["sk"], kernels["dk"]
    counters = [kernels[k] for k in ("rk", "fk", "bk", "sk", "ck", "dk")]
    records = bf16_kernel_records(torch, np, rk, fk, sk, sampling, prng, topology, card)
    counted, paths = {}, {}

    def count(name, launches, path):
        counted[f"{name}, bfloat16"] = {f"{name}, bfloat16": launches[name]}
        paths[f"{name}, bfloat16"] = path

    T = MAIN_ITERATIONS
    main = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                                n_workers=256, n_iterations=T, eval_every=1)
    ds = pkg.generate_synthetic_dataset(main)
    _, f_opt = pkg.compute_reference_optimum(ds, main.reg_param)
    ips = {}
    for dtype in ("float32", "bfloat16"):
        for impl in ("pallas", "stencil"):
            cfg = main.replace(dtype=dtype, mixing_impl=impl)
            res, launches = _bf16_run(torch, pkg, counters, cfg, ds, f_opt,
                                      f"bfloat16: main {dtype}")
            h = res.history
            crossed = pkg.iterations_to_threshold(h.objective, cfg.suboptimality_threshold,
                                                  h.eval_iterations)
            ips[dtype, impl] = h.iters_per_second
            check(launches["sample_worker_batch_weights"] == T,
                  f"main {dtype} {impl}: the dense sampler launched "
                  f"{launches['sample_worker_batch_weights']} times, not T")
            if impl == "pallas":
                check(launches["fused_ring_dsgd_step"] == T,
                      f"main {dtype}: the fused step launched {launches['fused_ring_dsgd_step']}")
            if dtype == "bfloat16":
                say(f"[bfloat16] main {impl}: {h.iters_per_second:.1f} iters/s (float32 "
                    f"{ips['float32', impl]:.1f}), final gap {h.objective[-1]:.6f}, iteration at "
                    f"eps={cfg.suboptimality_threshold}: "
                    f"{crossed if crossed > 0 else 'not crossed within T'} ({card})")
                if impl == "pallas":
                    count("fused_ring_dsgd_step", launches,
                          "bfloat16: main, dsgd, ring, N=256, pallas, bfloat16, T=30,000")
                    count("sample_worker_batch_weights", launches,
                          "bfloat16: main, N=256, dense sampling, bfloat16, once a step")
    # The card against the port's CPU run of the same config at a short T.
    _bf16_card_vs_cpu(torch, np, pkg, main.replace(mixing_impl="pallas", sampling_impl="dense"),
                      ds, f_opt, "main's config")
    # Main's shapes under 20% drops and 10% stragglers: the floats the realized
    # edges carried are the float32 run's exactly (float32 W_t, the keys of a
    # float32 run).
    faulted = main.replace(edge_drop_prob=0.2, straggler_prob=0.1, mixing_impl="stencil",
                           n_iterations=BF16_FAULT_ITERATIONS, eval_every=10)
    floats = {}
    for dtype in ("float32", "bfloat16"):
        res, launches = _bf16_run(torch, pkg, counters, faulted.replace(dtype=dtype), ds,
                                  f_opt, f"bfloat16: faults {dtype}")
        floats[dtype] = res.history.total_floats_transmitted
        check(launches["realize_round"] == faulted.n_iterations,
              f"faults {dtype}: the round launched {launches['realize_round']} times, not T")
    say(f"[bfloat16] main's shapes, 20% drops, 10% stragglers, T={faulted.n_iterations}: floats "
        f"sent bfloat16 {floats['bfloat16']:.1f}, float32 {floats['float32']:.1f} "
        f"({'equal' if floats['bfloat16'] == floats['float32'] else 'DIFFER'})")
    check(floats["bfloat16"] == floats["float32"], "bfloat16 faults: floats sent differ")
    # The kernels' short runs: GT on the parity ring (gather sampler, ring_mix
    # 2T), ADMM on main's ring (ring_neighbor_sum T + 1), D-SGD and ADMM on
    # the fully connected N=25 (fc_mix T, fc_neighbor_sum T + 1).
    S = BF16_SHORT_ITERATIONS
    parity = pkg.ExperimentConfig(problem_type="logistic", dtype="bfloat16", n_iterations=S,
                                  eval_every=10, mixing_impl="pallas")
    pds = pkg.generate_synthetic_dataset(parity)
    _, p_opt = pkg.compute_reference_optimum(pds, parity.reg_param)
    for label, cfg, data, opt, want in (
            ("gt parity ring", parity.replace(algorithm="gradient_tracking"), pds, p_opt,
             {"ring_mix": 2 * S, "sample_worker_batches": S}),
            ("admm main ring", main.replace(dtype="bfloat16", algorithm="admm",
                                            mixing_impl="pallas", n_iterations=S,
                                            eval_every=10), ds, f_opt,
             {"ring_neighbor_sum": S + 1, "sample_worker_batch_weights": S}),
            ("dsgd fc N=25", parity.replace(topology="fully_connected"), pds, p_opt,
             {"fc_mix": S, "sample_worker_batches": S}),
            ("admm fc N=25", parity.replace(topology="fully_connected", algorithm="admm"), pds,
             p_opt, {"fc_neighbor_sum": S + 1, "sample_worker_batches": S})):
        res, launches = _bf16_run(torch, pkg, counters, cfg, data, opt,
                                  f"bfloat16: {label}")
        check(launches == _only(launches, **want), f"bfloat16 {label}: launches {launches}, "
                                                   f"not {want}")
        for name in want:
            if f"{name}, bfloat16" not in counted:
                count(name, launches, f"bfloat16: {label}, pallas, bfloat16, T={S}")
    records.update(bf16_robust_records(torch, np, kernels["bk"], topology, card))
    records["compress_exchange, bfloat16"] = bf16_compression_records(torch, kernels["ck"], card)
    bf16_layer_runs(torch, np, pkg, counters, card, count)
    compute_bound_bf16(torch, np, pkg, counters, card)
    return records, counted, paths


def compute_bound_bf16(torch, np, pkg, counters, card):
    """bench_compute_bound.py's d4096_bf16 and d8192_bf16 cells, stencil and
    pallas: finite and decreasing over T (metrics on), every one of the 512
    labels through exact (int32), then timed with metrics off; TFLOP/s =
    4·N·b·d·K × iters/s against the dense bfloat16 peak."""
    n, b, k = COMPUTE_BOUND["n_workers"], COMPUTE_BOUND["local_batch_size"], COMPUTE_BOUND["n_classes"]
    T, every = COMPUTE_BOUND_ITERATIONS, COMPUTE_BOUND_EVAL_EVERY
    for d_feat in COMPUTE_BOUND_FEATURES:
        ds = _bench_dataset(np, pkg, n, b, d_feat, k)
        stacked = pkg.stack_shards(ds, "bfloat16")
        labels = np.concatenate([ds.y_full[idx] for idx in ds.shard_indices])
        check(stacked.y.dtype == np.int32 and np.array_equal(stacked.y.reshape(-1), labels)
              and len(np.unique(stacked.y)) == k,
              f"d={d_feat}: the {k} labels did not come through exact as int32")
        d = d_feat + 1
        flops = 4.0 * n * b * d * k
        base = pkg.ExperimentConfig(**{**COMPUTE_BOUND, "dtype": "bfloat16"}, n_samples=n * b,
                                    n_features=d_feat, n_iterations=T, eval_every=every,
                                    matmul_precision="default")
        for impl in ("stencil", "pallas"):
            cfg = base.replace(mixing_impl=impl)
            label = f"compute-bound d{d_feat}_bf16 K={k} {impl}"
            for c in counters:
                c.reset_launch_counts()
            h = pkg.run(cfg, ds, 0.0, device="cuda").history
            counted = {name: v for c in counters for name, v in c.LAUNCHES.items()}
            want = _only(counted, **({"fused_ring_dsgd_step": T} if impl == "pallas" else {}))
            check(counted == want, f"{label}: launches {counted}, not {want}")
            check(bool(np.all(np.isfinite(h.objective))) and h.objective[-1] < h.objective[0],
                  f"{label}: the objective {h.objective} is not finite and decreasing")
            timed = pkg.run(cfg, ds, 0.0, device="cuda", collect_metrics=False).history
            ips = timed.iters_per_second
            say(f"[bfloat16] {label}: objective {h.objective[0]:.4f} -> {h.objective[-1]:.4f} over "
                f"T={T}, {k} labels exact (int32); metrics off {ips:.2f} iters/s = "
                f"{flops * ips / 1e12:.2f} TFLOP/s ({flops / 1e9:.1f} GFLOP an iteration), "
                f"{flops * ips / PEAK_BF16_FLOPS:.1%} of the dense bfloat16 peak "
                f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; metrics on {h.iters_per_second:.2f} "
                f"iters/s; warm-up and capture {timed.compile_seconds:.2f} s ({card})")
        del ds, stacked
        torch.cuda.empty_cache()


def _profile_window(torch, prof, steady):
    """Device operations inside the run loop's steady range (the iterations
    after the warm-up chunk): (events, start, end) in µs. The profiler
    mirrors the range onto the device's track as an annotation, which is
    no operation and is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    loop = [e for e in prof.events()
            if e.name == steady and e.device_type == torch.autograd.DeviceType.CPU]
    check(len(loop) == 1, f"the profile holds {len(loop)} host ranges named {steady}")
    lo, hi = loop[0].time_range.start, loop[0].time_range.end
    device = [e for e in prof.events() if e.device_type == cuda and e.name != steady
              and lo <= e.time_range.start and e.time_range.end <= hi]
    return device, lo, hi


def _profile_run(torch, pkg, steady, cfg, label, T, data=None):
    """The graph run and the measured chunk loop of ``cfg`` under
    torch.profiler: device operations, busy µs and busy share over the
    iterations after the warm-up chunk. ``data``: (dataset, f*), else the
    config's synthetic dataset and its optimum."""
    from torch.profiler import ProfilerActivity, profile

    if data is None:
        ds = pkg.generate_synthetic_dataset(cfg)
        _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    else:
        ds, f_opt = data
    steps = T - cfg.eval_every
    for measure in (False, True):
        pkg.run(cfg, ds, f_opt, device="cuda", measure_timestamps=measure)  # warm
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = pkg.run(cfg, ds, f_opt, device="cuda", measure_timestamps=measure)
        device, lo, hi = _profile_window(torch, prof, steady)
        loop = "measured chunk loop" if measure else "graph replays"
        if not device:
            say(f"[profile] {label} T={T} {loop}: the profiler recorded no device activity "
                f"in the steady loop; not measured")
            continue
        start = min(e.time_range.start for e in device)
        end = max(e.time_range.end for e in device)
        busy = sum(e.time_range.elapsed_us() for e in device)
        by_name = {}
        for e in device:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        say(f"[profile] {label} T={T} {loop}: {len(device) / steps:.1f} device ops/iteration, "
            f"device busy {busy / (hi - lo):.3f} of {(hi - lo) / steps:.1f} us/iteration "
            f"({busy / steps:.1f} us busy; first to last device op {(end - start) / steps:.1f} "
            f"us/iteration), {res.history.iters_per_second:.1f} iters/s under the profiler")
        for name, (total, count) in top:
            say(f"[profile]   {total / steps:8.2f} us/iteration  {count / steps:5.1f}/iteration"
                f"  {name[:90]}")


def phase_profile(torch, pkg, steady, T: int = 300):
    parity = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                                  n_iterations=T, mixing_impl="pallas", dtype="float32",
                                  eval_every=1)
    _profile_run(torch, pkg, steady, parity, "parity N=25 pallas (gather sampling)", T)
    for algorithm in ("dsgd", "admm", "gradient_tracking"):
        for impl in ("pallas", "stencil"):
            cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm=algorithm,
                                       n_workers=256, n_iterations=T, mixing_impl=impl,
                                       dtype="float32", eval_every=1)
            _profile_run(torch, pkg, steady, cfg, f"{algorithm} N=256 {impl}", T)
    cfg = robust_config(pkg, T).replace(attack="sign_flip", n_byzantine=12, attack_scale=5.0,
                                        aggregation="trimmed_mean", robust_b=1,
                                        robust_impl="fused")
    _profile_run(torch, pkg, steady, cfg, "robust N=256 sign_flip trimmed_mean fused", T)
    _profile_run(torch, pkg, steady, cfg.replace(edge_drop_prob=ROBUST_EDGE_DROP),
                 "robust N=256 sign_flip trimmed_mean fused, 10% edge drops", T)
    faulted = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", n_workers=256,
                                   n_iterations=T, mixing_impl="pallas", dtype="float32",
                                   eval_every=1, **FAULT_MAIN)
    _profile_run(torch, pkg, steady, faulted, "dsgd N=256, 20% edge drops, 10% stragglers", T)
    for name in ("edge20_straggler10", "one_peer_gossip", "gt_edge_drop_20pct"):
        cfg = pkg.ExperimentConfig(**dict(FAULTS_BASE, n_iterations=T, **FAULT_ROWS[name][0]))
        _profile_run(torch, pkg, steady, cfg, f"faults N=64 {name}", T)
    for name in ("choco_randk27", "gt_qsgd4"):
        fields = COMPRESSION_RUNS[name][0]
        cfg = pkg.ExperimentConfig(problem_type="logistic", n_workers=256, n_iterations=T,
                                   mixing_impl="pallas", dtype="float32", eval_every=1, **fields)
        _profile_run(torch, pkg, steady, cfg, f"{name} N=256 pallas", T)
    for name, impls in (("dsgd_er256", ("auto", "gather", "sparse")), ("push_sum_der256", ("auto",))):
        fields = IRREGULAR_RUNS[name][0]
        for impl in impls:
            cfg = pkg.ExperimentConfig(problem_type="logistic", n_workers=256, n_iterations=T,
                                       mixing_impl=impl, dtype="float32", eval_every=1, **fields)
            _profile_run(torch, pkg, steady, cfg, f"{name} {impl}", T)
    for fields, label in ((HUBER_MAIN, "huber N=256"), (SOFTMAX_STUDY, "softmax K=10 N=25")):
        cfg = pkg.ExperimentConfig(**fields, n_iterations=T, mixing_impl="pallas",
                                   dtype="float32", eval_every=1)
        _profile_run(torch, pkg, steady, cfg, f"{label} pallas", T)
    for impl in ("pallas", "stencil"):
        cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", n_workers=256,
                                   n_iterations=T, mixing_impl=impl, dtype="bfloat16",
                                   eval_every=1)
        _profile_run(torch, pkg, steady, cfg, f"dsgd N=256 {impl} bfloat16", T)
    import numpy as np

    d_feat = COMPUTE_BOUND_FEATURES[0]
    n, b, k = COMPUTE_BOUND["n_workers"], COMPUTE_BOUND["local_batch_size"], COMPUTE_BOUND["n_classes"]
    data = (_bench_dataset(np, pkg, n, b, d_feat, k), 0.0)
    for precision in ("highest", "default"):
        cfg = pkg.ExperimentConfig(**COMPUTE_BOUND, n_samples=n * b, n_features=d_feat,
                                   n_iterations=40, eval_every=10, mixing_impl="pallas",
                                   matmul_precision=precision)
        _profile_run(torch, pkg, steady, cfg, f"compute-bound d={d_feat} {precision} pallas "
                     "(eval every 10)", cfg.n_iterations, data)
    cfg = pkg.ExperimentConfig(**{**COMPUTE_BOUND, "dtype": "bfloat16"}, n_samples=n * b,
                               n_features=d_feat, n_iterations=40, eval_every=10,
                               mixing_impl="pallas")
    _profile_run(torch, pkg, steady, cfg, f"compute-bound d={d_feat} bfloat16 pallas "
                 "(eval every 10)", cfg.n_iterations, data)
    _profile_federated(torch, pkg, steady)


def _profile_federated(torch, pkg, steady):
    """torch.profiler breakdowns of the federated cells' steady loops, graph
    and measured: ER N=10,000 neighbor (cell (i), T = 400, an eval every
    100), er_100k fault-free and faulted (T = 100, an eval every 25) and
    the million-worker ring (T = 40, an eval every 10)."""
    base = pkg.ExperimentConfig(**FEDERATED_BASE)
    n = FEDERATED_SCALE_N[-1]
    cells = (
        (base.replace(n_workers=n, n_samples=2 * n, topology="erdos_renyi",
                      erdos_renyi_p=12.0 / n, local_batch_size=4, n_iterations=400,
                      eval_every=FEDERATED_SCALE_T, topology_impl="neighbor"),
         f"federated scale N={n} neighbor"),
        (base.replace(**dict(ER_100K, n_iterations=100)), "federated er_100k fault-free"),
        (base.replace(**dict(ER_100K, n_iterations=100), **ER_100K_FAULTS),
         "federated er_100k faulted"),
        (base.replace(**RING_1M, n_iterations=40, eval_every=RING_1M_T), "federated ring_1m"),
    )
    data = {}
    for cfg, label in cells:
        key = (cfg.n_workers, cfg.topology)
        if key not in data:
            ds = pkg.generate_synthetic_dataset(cfg)
            data[key] = (ds, pkg.compute_reference_optimum(ds, cfg.reg_param)[1])
        _profile_run(torch, pkg, steady, cfg, label, cfg.n_iterations, data[key])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--ab-baseline",
                    help="the root of the other tree (a checkout) that phase ab compares with")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if ("ab" in phases) != (args.ab_baseline is not None):
        ap.error("phase ab and --ab-baseline go together")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    import numpy as np

    from distributed_optimization_tpu_torch.ops import _cuda_build
    from distributed_optimization_tpu_torch.ops import compression_kernels as ck
    from distributed_optimization_tpu_torch.ops import draw_kernels as dk
    from distributed_optimization_tpu_torch.ops import fc_kernels as fk
    from distributed_optimization_tpu_torch.ops import ring_kernels as rk
    from distributed_optimization_tpu_torch.ops import prng, sampling
    from distributed_optimization_tpu_torch.ops import robust_kernels as bk
    from distributed_optimization_tpu_torch.ops import sampling_kernels as sk
    from distributed_optimization_tpu_torch.ops.robust_aggregation import (
        make_gather_robust_aggregator,
    )
    from distributed_optimization_tpu_torch.parallel import topology
    pkg = _package()
    kernels = {"build": _cuda_build, "rk": rk, "fk": fk, "bk": bk, "sk": sk, "ck": ck, "dk": dk}

    t_start = time.perf_counter()
    t_last = [t_start]

    def lap(name):
        now = time.perf_counter()
        say(f"[time] {name}: {now - t_last[0]:.1f} s")
        t_last[0] = now

    card = phase_card(torch, kernels)
    lap("card")
    records = {}
    if "kernels" in phases:
        records = phase_kernels(torch, np, kernels, topology, make_gather_robust_aggregator)
        records.update(kernels_matrix_free(torch, np, dk, pkg))
        lap("kernels")
    if "sampling" in phases:
        records.update(phase_sampling(torch, np, sk, sampling, prng))
        lap("sampling")
    if "reference" in phases:
        phase_reference(torch, pkg, rk, bk)
        lap("reference")
    paths = {
        "fused_ring_dsgd_step": "main: dsgd, ring, N=256, mixing_impl=pallas",
        "ring_mix": "mixing: MixingOp(pallas).apply",
        "ring_neighbor_sum":
            "admm: ring, N=256, mixing_impl=pallas, T+1 (init and every iteration)",
        "fc_mix": "fc: dsgd, fully_connected, N=25, mixing_impl=pallas",
        "fc_neighbor_sum":
            "admm: fully_connected, N=25, mixing_impl=pallas, T+1 (init and every iteration)",
        "make_fused_robust_aggregator":
            "robust_mixing: byz_mix of the robust run's final models, one per rule",
        "make_fused_robust_dsgd_step":
            "robust: three fused runs (trimmed_mean, median, clipped_gossip), T each",
        **SAMPLING_PATHS,
        "compress_exchange":
            "compression: choco, random_k k=27, ring, N=256, pallas, once a step (GT twice)",
        "realize_round":
            "faults: dsgd, ring, N=256, 20% edge drops and 10% stragglers, once a step",
        "fault_timeline":
            "churn: gt_churn_frozen, GT, N=16 ring, bursty edges and churn, once a run",
        "large_noise": "byzantine: noise_plain, N=64, d=11, once a step",
        "sample_worker_batch_weights, replica axis":
            "replicas: main's config, N=256 ring, R=8, dense sampling, once a step",
        "sample_worker_batches, replica axis":
            "replicas: flagship_n25 sweep cell, R=32, gather sampling, once a step",
        "realize_round, replica axis":
            "replicas: main's shapes, bursty drops, churn, sign-flip, R=4, once a step",
        "large_noise, replica axis":
            "replicas: robust cell under large_noise, gather trimmed mean, R=4, once a step",
        "realize_slot_round":
            "federated: er_100k (ER N=100,000, sparse sampler), 10% iid drops, participation "
            "0.5, two launches a step",
        "fault_timeline, per-edge stream":
            "federated: er_100k under 10% iid drops and participation 0.5, two launches a run",
        "sample_event_block":
            "async: main's shapes on the event clock (N=256 ring, lognormal 1.25, T=200), "
            "once a block of 256 events (T·N / 256)",
    }
    counted = {}
    if "parity" in phases:
        counted["sample_worker_batches"] = phase_parity(torch, np, pkg, rk, sk)
        lap("parity")
    if "main" in phases:
        main_res, launches = phase_main(torch, np, pkg, rk, sk, MAIN_ITERATIONS)
        counted["fused_ring_dsgd_step"] = launches
        counted["sample_worker_batch_weights"] = launches
        lap("main")
        if "mixing" in phases:
            counted["ring_mix"] = phase_mixing(torch, pkg, rk, main_res.final_models)
    if "fc" in phases:
        counted["fc_mix"] = phase_fc(torch, np, pkg, fk)
        lap("fc")
    if "admm" in phases:
        counted.update(phase_admm(torch, np, pkg, rk, fk))
        lap("admm")
    if "tracking" in phases:
        counted["ring_mix"], counted["make_fused_robust_aggregator"] = phase_tracking(
            torch, np, pkg, kernels)
        paths["ring_mix"] = "tracking: gradient_tracking, ring, N=256, pallas, 2 a step"
        paths["make_fused_robust_aggregator"] = (
            "tracking: gradient_tracking, sign-flip, trimmed_mean fused, N=256, 2 a step")
        lap("tracking")
    if "compression" in phases:
        records["compress_exchange"], counted["compress_exchange"] = phase_compression(
            torch, np, pkg, kernels, prng)
        lap("compression")
    if "topologies" in phases:
        phase_topologies(torch, np, pkg, kernels)
        lap("topologies")
    if "push_sum" in phases:
        counted["ring_mix"] = phase_push_sum(torch, np, pkg, kernels)
        paths["ring_mix"] = "push_sum: push_sum, ring, N=256, pallas, 2 a step (num and w)"
        lap("push_sum")
    if "study" in phases:
        phase_study(torch, np, pkg)
        lap("study")
    if "byzantine" in phases:
        counted["large_noise"] = phase_byzantine(np, pkg, bk, dk)
        lap("byzantine")
    if "robust" in phases:
        robust_models, launches = phase_robust(np, pkg, bk, rk, dk)
        robust_er(torch, np, pkg, bk, rk)
        robust_dense_fc(torch, np, pkg, bk)
        counted["make_fused_robust_dsgd_step"] = launches
        paths["make_fused_robust_dsgd_step"] = (
            "robust: edges10_trimmed_mean_fused, dsgd, ring, N=256, sign-flip, 10% edge drops, "
            "once a step")
        lap("robust")
        if "robust_mixing" in phases:
            counted.setdefault("make_fused_robust_aggregator", phase_robust_mixing(
                torch, np, pkg, kernels, robust_models))
    if "objectives" in phases:
        huber, softmax = phase_objectives(torch, np, pkg, kernels, topology, card)
        for name, launches, path in (
                ("fused_ring_dsgd_step", huber, "objectives: huber dsgd, ring, N=256, pallas"),
                ("sample_worker_batch_weights", huber,
                 "objectives: huber dsgd, ring, N=256, dense sampling"),
                ("sample_worker_batches", softmax,
                 "objectives: softmax K=10 dsgd, ring, N=25, gather sampling")):
            if name not in counted:
                counted[name], paths[name] = launches, path
        lap("objectives")

    if "faults" in phases:
        records.update(draw_kernel_records(torch, np, dk, bk, pkg))
        counted["realize_round"] = phase_faults(torch, np, pkg, kernels)
        lap("faults")
    if "churn" in phases:
        counted["fault_timeline"] = phase_churn(torch, np, pkg, kernels)
        lap("churn")
    if "replicas" in phases:
        replica_records, replica_counted = phase_replicas(
            torch, np, pkg, kernels, main_res if "main" in phases else None)
        records.update(replica_records)
        counted.update({name: {name: launches} for name, launches in replica_counted.items()})
        lap("replicas")

    if "federated" in phases:
        launches = phase_federated(torch, np, pkg, kernels)
        counted["realize_slot_round"] = {"realize_slot_round": launches["realize_slot_round"]}
        counted["fault_timeline, per-edge stream"] = {
            "fault_timeline, per-edge stream": launches["fault_timeline"]}
        lap("federated")

    if "async" in phases:
        records["sample_event_block"], launches = phase_async(torch, np, pkg, kernels)
        counted["sample_event_block"] = launches
        lap("async")

    if "bfloat16" in phases:
        bf16_records, bf16_counted, bf16_paths = phase_bfloat16(
            torch, np, pkg, kernels, topology, sampling, prng, card)
        records.update(bf16_records)
        counted.update(bf16_counted)
        paths.update(bf16_paths)
        lap("bfloat16")

    if "profile" in phases:
        from distributed_optimization_tpu_torch.backends.torch_backend import STEADY_LOOP

        phase_profile(torch, pkg, STEADY_LOOP)
        lap("profile")
    if "ab" in phases:
        phase_ab(torch, np, pkg, kernels, topology, args.ab_baseline)
        lap("ab")

    if records:
        kernel_records = []
        for name, record in records.items():
            launches = counted.get(name)
            kernel_records.append({**record,
                                   "launches": None if launches is None else launches[name],
                                   "path": paths[name]})
        if set(records) <= set(counted):
            check(all(k["launches"] > 0 for k in kernel_records),
                  "a ported kernel was not launched on its path")
        say(json.dumps({"kernels": kernel_records}))
    say(f"[done] phases {','.join(phases)} in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _package():
    """The port's entry points, gathered into one namespace."""
    import types

    from distributed_optimization_tpu_torch.algorithms import get_algorithm
    from distributed_optimization_tpu_torch.backends.async_scan import (
        event_block,
        event_faults_for,
        run_async,
    )
    from distributed_optimization_tpu_torch.backends.async_scan import (
        timeline_for as async_timeline_for,
    )
    from distributed_optimization_tpu_torch.backends.torch_backend import (
        bind_byzantine,
        resolve_robust_impl,
        run,
        run_batch,
    )
    from distributed_optimization_tpu_torch.config import ExperimentConfig
    from distributed_optimization_tpu_torch.metrics import iterations_to_threshold
    from distributed_optimization_tpu_torch.ops import prng
    from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
    from distributed_optimization_tpu_torch.ops.sampling import event_key
    from distributed_optimization_tpu_torch.ops.sampling import (
        sample_event_block as plain_event_block,
    )
    from distributed_optimization_tpu_torch.parallel.adversary import byzantine_mask
    from distributed_optimization_tpu_torch.parallel.faults import (
        build_fault_timeline,
        outage_stats,
        windowed_connectivity,
    )
    from distributed_optimization_tpu_torch.parallel.events import (
        clock_skew,
        staleness_histogram,
        sync_round_times,
    )
    from distributed_optimization_tpu_torch.parallel.topology import build_topology
    from distributed_optimization_tpu_torch.utils.data import (
        HostDataset,
        generate_synthetic_dataset,
        stack_shards,
    )
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    # The phases draw the same datasets again and again (main's N=256 split
    # takes seconds with its optimum): each is made once, by the fields the
    # generator reads, and each optimum once a dataset and its arguments.
    datasets, optima = {}, {}

    def dataset(config):
        key = (config.resolved_data_seed(), config.problem_type, config.n_samples,
               config.n_features, config.n_informative_features, config.classification_sep,
               config.n_classes, config.partition, config.n_workers)
        if key not in datasets:
            datasets[key] = generate_synthetic_dataset(config)
        return datasets[key]

    def optimum(ds, reg_param, **kw):
        key = (id(ds), reg_param, tuple(sorted(kw.items())))
        if key not in optima:  # the entry holds ds, so its id is not reused
            optima[key] = (ds, compute_reference_optimum(ds, reg_param, **kw))
        return optima[key][1]

    return types.SimpleNamespace(
        run=run, run_batch=run_batch, ExperimentConfig=ExperimentConfig,
        bind_byzantine=bind_byzantine,
        resolve_robust_impl=resolve_robust_impl,
        get_algorithm=get_algorithm,
        iterations_to_threshold=iterations_to_threshold, make_mixing_op=make_mixing_op,
        build_topology=build_topology, generate_synthetic_dataset=dataset,
        compute_reference_optimum=optimum, HostDataset=HostDataset,
        prng=prng, byzantine_mask=byzantine_mask, build_fault_timeline=build_fault_timeline,
        outage_stats=outage_stats, windowed_connectivity=windowed_connectivity,
        run_async=run_async, async_timeline_for=async_timeline_for,
        event_faults_for=event_faults_for, sync_round_times=sync_round_times,
        clock_skew=clock_skew, staleness_histogram=staleness_histogram, event_key=event_key,
        plain_event_block=plain_event_block, stack_shards=stack_shards,
        event_block=event_block,
    )


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
