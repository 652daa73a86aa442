#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``ndcn_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each:
  1. device: torch / CUDA versions, the card's name and power limit; TF32 off.
  2. build: the CUDA kernels from ``ndcn_tpu_torch/csrc`` with nvcc.
  3. K1 (CSR SpMV) against its plain PyTorch version: the 200k-node / ~2M-edge
     normalized Laplacian at d = 20 and d = 1, and a power-law graph with
     hub rows (the chunk kernels); max|Δ| / max|y| <= 1e-5; two calls
     bit-equal; median CUDA-event times of both, the bound, and the library
     call (``torch.sparse.mm`` over a CSR tensor).
  4. K2 (fused relu((A·H)·W + b), split TF32 on the tensor cores) against
     its plain version at (400, 20), (275, 13) and at every size of the
     sweep n in {400, 1000, 4000, 10000} x k in {20, 64, 128}: rtol 1e-5 /
     atol 1e-5·max|y| (the inputs are uniform on (0, 1), so a sum of n
     positive terms has no cancellation and every output is of the scale's
     order: the bar is in effect the port's max|Δ| <= 1e-5·max|y|, which two
     fp32 sums of 10,000 terms in different orders keep by a factor of ten);
     two calls bit-equal; within 2e-6 of the PyTorch emulation of the split
     product; times of the kernel, its plain version, the library call and
     the unfused route of ``ode_func`` (``fused=False``), and whether
     ``fused_profitable`` picks the route that was no slower on the card
     (ten calls behind a spin kernel; within 1.10x the routes are a tie).
  5. serve the 400-node grid (dense, fused="auto") with the oracle fixture's
     weights: 3 requests, the first within 1e-4 rel-L1 of the oracle.
  6. serve the 200k-node COO graph: 3 requests, the first again on the CPU
     (plain versions), GPU and CPU answers within 1e-4 rel-L1.
  7. the backward kernels and the BSR kernels against their plain versions,
     max|Δ| / max|y| <= 1e-5, with the median CUDA-event times of both: K1ᵀ
     (K1 over the transpose CSR) on the non-symmetric hub graph at d = 20;
     K2's backward (dh, dw, db) at 400 × 20 against autograd of the plain
     version; K3 and K3ᵀ (split TF32 on the tensor cores, as K4) on the
     grid400 Laplacian (d = 20) and on a 2000-node 5 % matrix (d = 20,
     256), bit-equal on a repeat and within 2e-6 of the emulation of its
     split product; K4 forward and backward on grid400 (d = 20)
     and on the 2000-node matrix (d = 256, 512), bit-equal on a repeat and
     within 2e-6 of the emulation of its split product (the backward's
     cotangent is zero within 1e-5·max|z| of relu's kink, the forward's
     own bound, where its last bits decide the mask: at most one element
     in 10,000, which the phase checks); and the BSR half of
     the ``fused_profitable`` sweep (both matrices, d in {20, 64, 128, 256,
     512}: K4 against K3 + linear + relu).
  8. train grid400, dense, fused="auto" (K2 forward and backward): the first
     step from the ``ndcn_grads_grid400`` weights within 1e-4 of the
     fixture's loss and 1e-3 rel-L1 of its gradients; steady per-step ms and
     NFE; then the heat experiment (``--fused_kernel``, 20 iterations), whose
     train loss must fall.
  9. train grid400, BSR, fused=False (K3) and fused=True (K4): the same
     fixture check, per-step ms, and the heat experiment with ``--sparse
     --sparse_format bsr`` for a few iterations.
 10. train the 200k-node COO graph (K1 and K1ᵀ): target from the port's heat
     ground truth at rtol 1e-6 / atol 1e-8, 5 steps, the first step's
     gradients within 1e-3 rel-L1 of the same step with the plain versions
     patched in; per-step ms and peak allocated memory.
 11. the scale path's SpMV kernels against their plain versions: K1's bf16
     instance, K1-fm and K5 (fp32 and bf16), forward and over the transpose,
     on the 200k / 2.2M and 1M / 11M normalized Laplacians at d = 20, K1
     fp32 at 1M, K1-fm and K5 on the hub graph, and K1-fm's pack kernel;
     max|Δ| / max|y| <= 1e-5 against the plain version of the same
     rounding; two calls bit-equal; median CUDA-event times of both, the
     bound and the library call.
 12. the scale experiment (``experiments.large_graph``) in process at 1M nodes,
     ``--iters 60 --roofline --hbm_probe`` (the iterations of the JAX
     record ``results/scale_1m_heat.json``, whose final rel-L1 its
     ``rel_loss_final`` is printed beside): 'auto' resolves to the
     feature-major solve, the train loss falls, K1-fm launches; its
     ``--estimate`` (with the attempts it assumed) beside the measured peak
     (with the attempts a step took); the first train step's
     gradients within 1e-3 rel-L1 of the same step with the plain versions;
     the run again with ``--emission_precision bf16 --residual_precision
     bf16``; then at 200k with ``--kernel_precision bf16`` (the (n, d)
     layout, K1's bf16 instance) and with ``--layout feature_major`` under
     ``GATHER_WIDE`` (K5), 3 iterations each; and the three solves of the
     1M step side by side (feature-major, feature-major under
     ``GATHER_WIDE``, the (n, d) layout), 10 iterations each. The phase
     builds each graph once and solves the 1M ground truth once (the
     driver's ``--gt_cache`` under build/).
 13. the three microbenchmarks at their defaults (``ndcn_tpu_torch.tools``):
     P1a (the sliced-tile reduce) and P1b / P2 (the row gather) against
     their plain versions and the oracle, and the narrow / wide table; P1a
     once more at the tool's size, bit-equal on a repeat; P1b's device time
     beside that of an empty launch (``torch.cuda._sleep(0)``, queued
     alike).
 14. K1-w (the mutualistic interaction, ``kernels.coo_mutual``) forward
     and backward against its plain version (gather, weight,
     ``index_add_``; no single PyTorch call computes the pair term, so the
     plain version is also the library yardstick) on the 50k, 200k and 1M
     adjacencies at d = 1, 200k at d = 2 and at the edge form's widest
     width, the hub graph at d = 1 (the edge form with carries) and 20, and
     its transpose at d = 20, each with the form that ran, read from the
     edge form's own launch count (it must be the edge form up to the
     crossover width, the warp form above): max|Δ| / max|y| <= 1e-5, two
     calls bit-equal, times and the bytes' bound; the mutualistic ground
     truth of a 5,000-node graph on the card within 1e-4 rel-L1 of the
     CPU's, its NFE within 2 %; then the scale
     experiment at 50k nodes with ``--dynamics mutualistic --iters 60``
     (the ground truth on the card through K1-w, training through K1) and
     ``--dynamics gene --iters 10``, and the mutualistic experiment on its
     defaults (euler, grid 400, dense), the gene experiment with ``--method
     dopri5 --sparse`` (ELL) and the mutualistic one with ``--method dopri5
     --sparse --sparse_format coo``, 20 iterations each: every train loss
     falls.
  15. the continuous adjoint, the other solvers and checkpoint / resume
     (input 1, hidden 20, output 1; rtol 0.01, atol 0.001): (a) a grid400
     adjoint train step at the ``ndcn_grads_grid400`` weights on three
     routes, dense ``fused="auto"`` (K2 forward, K2's backward products in
     the VJPs), COO (K1, K1 over the transpose CSR) and BSR ``fused=True``
     (K4, K3 over Aᵀ): loss within 1e-4 and gradients within 1e-3 rel-L1
     of the fixture's adjoint half, every gradient finite; forward and
     backward NFE, step ms and peak memory beside the backprop step's;
     (b) serving grid400 dense with tsit5, adams, fixed_adams and
     explicit_adams: the card's answer within 1e-4 rel-L1 of the CPU's,
     or within twice the CPU's own float32-vs-float64 distance where that
     is larger (explicit_adams, order 11 near its stability limit), NFE
     within 2 % (the CPU's answers, NFE and float32-vs-float64 distances
     are committed references, ``tests/fixtures/smoke_cpu_references.npz``
     from ``ndcn_tpu_torch.tools.smoke_references``); (c) the heat driver for 10 iterations with
     ``--adjoint`` and with ``--method adams`` (the train loss falls), and
     10 iterations against 5 checkpointed (``--ckpt_dir`` under build/,
     ``--ckpt_freq 5``) and a resumed 5: the losses bit-equal.
  16. the classification tasks on cora and citeseer (``data/``): (a) K1 and
     K1ᵀ on both operators at d = 7 / 6 (the classes), 16 (the hidden
     width) and 1433 / 3703 (the raw features), and K3 and K3ᵀ on cora's
     BSR operator at d = 7, 16, 1433, against their plain versions with
     [3] / [7]'s bars, bit-equal repeats, times, bounds and library calls;
     at 1433 / 3703 K1 must take its wide form (a warp a 32-lane tile of a
     row), bit-equal to the narrow form on the same inputs, whose device
     time is printed beside, and beside it again with the long rows cut at
     16 edges (where the narrow form's time went); K1 there also in bf16
     and on 2 row blocks (concatenated bit-equal to the whole launch);
     (b) one cora differential_gcn train step (weights from CPU generator
     seed 0, dropout 0, rtol = atol = 0.1) on dense, COO and BSR, on the
     card against the CPU (the committed reference of
     ``tools.smoke_references.cora_step``): loss within 1e-4, gradients
     within 1e-3 rel-L1, NFE equal, K1 / K3 launched; (c) the driver on
     its defaults
     (seed 0; its accuracy is printed, with no bar: the showcase is
     another recipe), then the recipe of
     ``results/showcase_cora_100.json`` (README.md:64: hidden 256, dropout
     0, T 1.2, tick 16, 100 epochs, weight decay 0.024, no control, alpha
     0) through ``experiments.dgnn`` in process at seeds 0-2, dense: the
     mean test accuracy within that record's 0.8317 ± 3 · 0.0098 / √3;
     seed 0 with ``--sparse`` (K1) and ``--sparse --sparse_format bsr``
     (K3), whose train loss must fall; citeseer seed 0 within 0.7065 ± 3 ·
     0.0061 (``results/showcase_citeseer_12.json``); (d) every zoo model
     through the driver on cora with ``--sparse`` for 100 epochs
     (DeepGCN3 dense, 50), the train loss falling, GCN's test accuracy
     within 2 points of the same run with ``--platform cpu`` (the same
     dropout masks; its accuracy is the committed reference); (e) the
     phase's own wall time.
 17. the temporal-GNN baselines, ``report``, the Lotka-Volterra demo and
     the T × alpha sweep: (a) K1 and K1ᵀ on the grid400 Kipf operator (COO)
     and K3 and K3ᵀ on its BSR form at d = 5, the baselines' graph width,
     with [3] / [7]'s bars, bit-equal repeats, times, bounds and library
     calls; (b) one train step of lstm_gnn, gru_gnn and rnn_gnn (weights
     from CPU generator seed 0) on the heat driver's data (grid400, T 5,
     tick 100, irregular, seed 0) on dense, COO and BSR, card against CPU
     (``tools.smoke_references.temporal_step``'s committed references):
     loss within 1e-4, gradients within 1e-3 rel-L1, 79 K1 (K3) launches
     forward and 79 over the transpose on COO (BSR), none on dense, with
     the per-step ms; (c) the heat driver for 20 iterations with lstm_gnn
     on COO, gru_gnn on BSR and rnn_gnn dense (the train loss falls, the
     final test error printed), and the lstm_gnn run again with ``--dump
     --profile_dir`` (and ``--viz`` where matplotlib imports; where it does
     not, the phase says so and makes no such run) under
     build/smoke_temporal: its losses within 1e-6 of the plain run's, the
     dump read back by ``report.results.load_results`` and
     ``experiments.summarize``, the trace written; (d) ``experiments.lv``
     for 40 iterations with rk4 and with dopri5 ``--adjoint`` (the mean of
     the last 20 train losses under that of the first 20: the batches are
     random), its first 20 train losses within 1e-4 of the same run on the
     CPU (committed references); (e) ``experiments.sweep_t_alpha`` on cora with
     the showcase recipe at seed 0, dense, T in {0.5, 1.2} × alpha in
     {0.0, 1.0}, then again with ``--resume``, which must rerun no cell;
     each cell beside ``results/t_alpha_grid_cora.csv``'s (a TPU record:
     no bar); (f) the phase's own wall time.
 18. the replica sweeps (``--replicas``, ``--batch_iters``): (a) the
     batched forms of K1, K2, K3 and K4 (R states, and K2 / K4's R weights,
     against one shared operator in one launch) on grid400 at d = 20 with
     R = 1 and 16, K1 and K3 also on cora at d = 16 with R = 25, K1 at
     1433 with R = 25 (its wide form), K3 at 256 with R = 25 and both K3
     cases over Aᵀ (replica groups at d = 16 and 20, the replica grid at
     256, as ``bsr_batched_plan`` picks): against
     their plain versions (<= 1e-5; K2-K4 within 2e-6 of their split
     emulation), each replica bit-equal to its own one-replica launch, two
     calls bit-equal; times beside R one-replica launches', the bound, the
     library route (``torch.sparse.mm`` / the BSR product on the replicas
     side by side as an (n, R·d) X; ``relu(baddbmm(b, A @ H, W))`` for K2 /
     K4) and, for K1 and K3, the stacked-width route (the replicas side by
     side through the one-replica kernel); (b) the heat driver with
     ``--replicas 16`` for 10 iterations on dense ``--fused_kernel`` (K2),
     COO (K1) and BSR (K4, K3): the train losses fall; replicas 0-3 of a
     16-replica step against their runs alone (the first step's losses
     within 1e-4, NFE equal; 3 steps' losses printed); time per
     model-step against a step alone; the busy share under the profiler;
     what one step launches at R = 4 and R = 16 (replicas 0-3 four times
     over): the ATen operators it calls and the port's kernels equal (the
     device kernels are printed beside: inside an operator cuBLAS and CUB
     pick their kernels by size, and the count parted by 0-5 of ~1,620 in
     the runs made), and a step alone's; (c) the showcase recipe through the dgnn driver
     with ``--batch_iters --iter 25``, and again with ``--budget_buckets
     4``: the mean accuracy within 0.8317 ± 3 · 0.0098 / √25, no replica
     exhausted, seconds per model beside [16]'s single runs, the peak
     memory beside the guard's estimate and under its limit; (d) the same
     sweep of 25 on BSR (``--sparse --sparse_format bsr``: K3's batched
     form at 256) within the same accuracy bar, its seconds per model
     beside (c)'s, and DeepGCN2 ``--sparse --batch_iters --iter 25`` for
     10 epochs (the shared raw features through K1's wide form once an
     epoch, the hidden width batched): each train loss falls, the kernels'
     launches counted.
 19. the mesh (``--mesh``, ``parallel.coo_shard``): (a) the 200k / 2.0M
     operator of [3] / [10] split into 4 row blocks in one process: K1 and
     K1-fm's gather (fp32 and bf16), on A's blocks and on Aᵀ's, each block
     against the gathered table; the blocks' outputs concatenated
     bit-equal to the whole operator's launch and within 1e-6·max|y| of
     the plain version; each block's times, bound and library call
     (``torch.sparse.mm`` on the block's CSR), their sums beside the whole
     launch's; K1's batched form on the blocks (4 replicas, the data x
     model mesh's product), each replica bit-equal to its own launch; (b) ``experiments.large_graph --mesh`` at 200k (hidden 20,
     5 iterations), in the (n, d) layout and feature-major, on a one-rank
     NCCL group: its first-step parity under 1e-4, the train loss falling,
     the row-block launches, steps/s beside the same run without
     ``--mesh``; one steady sharded train step's launches and busy share,
     and its time against the same step unsharded (bit-equal weights),
     alternating;
     (c) the heat driver with ``--mesh`` on one rank (the JAX notice: it
     runs unsharded) with the losses of the run without it. Only one card:
     meshes of more ranks are checked on the CPU (gloo), by
     ``python -m ndcn_tpu_torch.parallel.dryrun 4 --device cpu`` and the tests.
 [20]-[25] run beside each other in three processes on the card ([20],
 [22] and [25] in this one, [21] in a second, [23] and [24] in a third:
 ``side_main``), so every time they print is a host-clock one under the
 others' load (``LOADED``); [3]-[19], which time the kernels and their
 library calls, run alone.
 20. the serving artifact (``serve.export_ndcn``): grid400 dense
     ``fused="auto"`` (K2), grid400 BSR ``fused=False`` (K3) and ``"auto"``
     (K4) at the fixture's weights, and the 200k / 2.0M COO operator (K1),
     hidden 20, rtol 0.01, atol 0.001, each exported on the card and served
     by ``tools.serve_artifact`` in one fresh process that imports torch and
     the kernels' operators only: its answer within 1e-6 max|Δ| of the
     in-process ``Server``'s on the same weights, its kernel's launches in
     one request > 0 and equal to the server's NFE (one launch an RHS
     evaluation), the artifact's bytes, the median latency of 10 requests
     beside the server's, host reads per request; then the dgnn driver's
     ``--export`` on cora (the showcase recipe, 2 epochs), the served
     logits' test accuracy within 0.01 of the driver's.
 21. the Adams family and the continuous adjoint under replicas, and the
     artifact with the Adams methods and the feature-major layout (in a
     process of its own started after [19]: ``replica_phase``,
     ``artifact_phase``): (a) the
     heat driver with ``--replicas 4`` for 2 iterations with adams,
     fixed_adams and explicit_adams (at tick 20: its solve diverges on
     this model from tick 40 on; dense ``--fused_kernel``: K2's batched
     form), dopri5 ``--adjoint`` on dense (K2), COO (K1, K1ᵀ) and BSR (K4,
     K3, K3ᵀ), and adams ``--adjoint`` on dense; for each, the first step's
     losses and gradients of replica 0 against its run alone on the card
     and of the four against the CPU (losses 1e-4; gradients
     1e-3 rel-L1, or twice the CPU's own float32-vs-float64 distance where
     that is larger; for adams backprop the card's and the CPU's float32
     gradients each against the CPU's float64 ones, printed; the CPU's
     losses, gradients, NFE and float64 gradients are the committed
     references of [15] b), only batched
     forms launched, each replica's NFE and
     backward NFE, seconds a model-step beside [18]'s, the step's peak
     beside the memory guard's estimate; (b) grid400 dense with adams,
     fixed_adams and explicit_adams, the 1M / 11M COO operator of [12]
     with ``layout="auto"`` (feature-major: K1-fm's ``pack_rows`` and
     ``gather_T`` operators) and the 200k operator feature-major under
     ``GATHER_WIDE`` (K5's ``gather_T_wide``), exported on the card and
     served by ``tools.serve_artifact`` in one fresh process: against the
     in-process ``Server`` within 1e-6 max|Δ| (adams, the masked machine
     against the host-indexed solve: 1e-5 rel-L1), each kernel launched
     once an RHS evaluation (= the ``Server``'s NFE), the bytes, export
     seconds, median latency of 10 requests and host reads.
 22. the model axis's paths (``--mesh`` on more than one rank: the
     continuous adjoint, the temporal baselines, the GCN zoo), each on a
     row block over the one-rank NCCL world group itself (a real group,
     so that every collective of these paths runs on the card) against
     the same step on the whole operator: (a) the 200k / 2.0M COO
     ``--adjoint`` step of [10] (dopri5, hidden 20), (b) the lstm_gnn step
     on the grid400 Kipf operator (K1's row block at d = 5), (c) one cora
     epoch of GCN, DeepGCN2 (K1's wide form at 1433 on the row block) and
     DeepGCN3 (its dense rows against the gathered state, no K1): the
     loss and every gradient within 1e-4 rel-L1, NFE and backward NFE
     equal, the row-block kernels launched and the whole operator's K1
     not, the step's ms beside the unsharded one's; (d) the heat driver
     with ``--adjoint`` and with ``--baseline lstm_gnn``, the dgnn driver
     with ``--model GCN`` and with ``--batch_iters --iter 2 --model
     DeepGCN2`` (all on COO), with ``--mesh`` on one rank (the JAX notice)
     and without it: the same losses.
 23. (with [24], in a process of its own started after [19], beside
     [20]-[22] and [25]: ``side_main``) the scan path and ``--scan_chunk``
     (``ode.adaptive.solve_scan``,
     ``train.chunk``): on grid400 dense (``fused="auto"``: K2), BSR (K4,
     K3 in its backward) and COO (K1, K1ᵀ), 5 steps, and
     on [10]'s 200k COO operator, 5 steps (dopri5, hidden 20, the auto budget), three
     copies of one model from one init: the host loop, the eager bounded
     step and a ``TrainChunk`` of the same steps (one CUDA graph
     replayed): the graph's last loss and every parameter bit-equal to
     the eager bounded step's, one host read for the chunk; before each
     eager step the host loop's forward at its weights: losses within
     1e-5 rel-L1 and NFE equal; the attempts taken against ``max_steps``;
     K2, K4 + K3 and K1 in one replay's profiler trace (K1ᵀ: the eager
     step's backward launches K1 beyond its recomputation); step ms three
     ways (host loop, eager bounded, graph replay: median and range); one
     replay's device ms and busy share under the profiler; the eager
     bounded step's peak beside ``scan_train_bytes``; each kernel's
     launches in a graphed step; the heat driver with ``--scan_chunk 10``
     for 20 iterations on BSR and COO, on dense with a budget cut to 2
     (the elastic rollback captures again: one capture a rollback more),
     and with ``--baseline lstm_gnn`` on COO: a host read a chunk, the
     kernels launched, finite losses.
 24. ``--scan_chunk`` with the Adams family, the continuous adjoint and
     the mesh (``ode.vcabm.solve_vcabm_scan``, the bounded inference
     solve under ``ode.adjoint``, the solves' ``node_group``), as [23]'s
     settings (the host loop, the eager bounded step and the graph, 2
     steps; ``bounded_setting``) on the heat driver's grid400 data cut in
     time where a graph would hold too many attempts
     (``tools.smoke_references.SCAN_SETTINGS``): (a) adams at tick 20
     (``max_steps`` 32) and explicit_adams (tick 20: its solve diverges
     on this model from tick 40 on) on dense (K2); (b)
     the dopri5 adjoint at tick 6 (4 intervals × 12 attempts) on dense
     (K2), COO (K1, K1ᵀ) and BSR (K4 + K3), and adams' adjoint (16
     attempts); the first bounded step of each against the CPU's
     committed reference (loss 1e-4, gradients 1e-3, NFE equal), the
     adjoint's backward NFE an interval;
     (c) [10]'s 200k COO step on a row block over the one-rank NCCL world
     group (the solve's norms and the gradients' sum as collectives in
     the graph; the row block's K1 launched, the whole operator's not),
     beside [23]'s unsharded 200k step; then the heat driver with
     ``--scan_chunk 3`` for 6 iterations with adams (tick 20) and with the
     adjoint on COO (tick 6). Each setting prints live attempts beside
     ``max_steps``, step ms three ways, capture seconds, launches a
     replay and each kernel's count in one replay's trace, the eager
     peak beside ``scan_train_bytes``.
  p. where the time goes: one request per serving setting and one train step
     per training setting (the 1M feature-major step included), one cora
     differential_gcn epoch (the driver's defaults, train and eval) on
     dense, COO and BSR, one lstm_gnn train step on the grid400 Kipf
     operator (COO), kernels against plain versions end to end (plain,
     kernel, kernel, plain), a torch.profiler breakdown (traces to
     build/traces/), and each kernel's launches in that one steady step or
     epoch.
 25. the scale-record tools, ``analyze_mesh_tax`` and the quickstart
     (``ndcn_tpu_torch.tools``, ``experiments.quickstart``), after [22]:
     (a) ``profile_scale_step`` at 200k on [10]'s
     problem and weights (fp32 gather): its ``nfe`` equal to [10]'s first
     host-loop step's, every level > 0 ms, the (n, d) layout; (b)
     ``bench_scale --n 200000 --iters 5 --repeats 1`` in a process of its
     own beside (a) and (c)-(e), into a temporary directory under build/:
     the record's keys and its ``card`` the smoke's ``nvidia-smi`` line; (c)
     ``analyze_mesh_tax`` at 200k (``step_u``, ``step_s``, ``fwd_u``,
     ``fwd_s``, 2 reps): the sharded losses within 1e-5 of the whole ones
     with NFE equal, K1's row-block launches in the sharded variants'
     histograms and the whole K1's in the others'; (d) ``record_showcase``
     on cora with ``--batch_iters --iter 4 --epochs 20``: its record and
     card; (e) the quickstart for 50 iterations (K2 under
     ``fused="auto"``): finite losses that fall.
Then each phase's wall seconds (``[t]``), the kernels' JSON record, and
last the device JSON line. Launch counts
are zeroed just before each main-path phase (5-6, 8, 9, 10, each run of 12,
13, 14, each part of 15, each run of 16 and 17, each driver run of 18 and
19, each in-process request of 20 and 21, each driver run of 21, each
row-block step and driver run of 22, each step and driver run of 23 and
24 and each driver run of 21 a, counted in their own processes and added,
each tool of 25)
and read just after its GPU work (a graph's replays launch what its
capture counted);
the served artifacts of 20 and 21 count their own launches in their own
processes, and the record's launches are the sums of all of them
(``launches_in_artifact``: K1-K4, K1-fm's pack and gather and K5 in one
request of their artifact).

``ms`` is the median CUDA-event time of one call on an idle card, as in
every earlier record; every kernel also gives ``device_ms``, the time per
call of ten calls queued behind a spin kernel, which leaves the host's part
out. Every timed kernel also gets ``bound_ms``, the least time the card could
take: the larger of the bytes the function must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the peak
for their type, computed from this run's shapes: 67 TFLOP/s for fp32 outside
the tensor cores, and for the split-TF32 products of K2, K3 and K4 three
times the operations over the tensor cores' 495 TFLOP/s; and
``library_ms``, the time of one PyTorch call that computes the same function
on the same inputs, where there is one. The port calls none of those library
functions.

Exits non-zero, printing no result, when there is no CUDA device or the
package is missing; any failed check raises.
"""

import atexit
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def rel_l1(a, b) -> float:
    return float((a - b).abs().mean() / (b.abs().mean() + 1e-12))


# the card's published peaks: HBM bytes/s, fp32 FLOP/s outside the tensor
# cores, and dense TF32 FLOP/s on them. A split-TF32 product (K2-K4) runs
# three tensor-core passes for every fp32 product it stands for.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "split_tf32": 495e12 / 3}

# 'auto' must pick the route whose time on the card is no more than this
# factor over the other's; shapes inside the factor are printed as ties
ROUTE_TIE = 1.10

# what [20]-[24]'s records say of their times
LOADED = ("host-clock, taken while [20]-[22] and [23] / [24] shared the "
          "card from two processes")


def bound(n_bytes: float, flops: float, kind: str = "fp32") -> dict:
    """The least time the card could take for ``n_bytes`` moved and ``flops``
    operations of arithmetic ``kind``, and which of the two sets it."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "flops": int(flops), "arithmetic": kind}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_call(fn, label: str, root: str) -> dict:
    """Where one call of ``fn`` (a served request or a train step) spends its
    time.

    First the end-to-end time with the CUDA kernels against the same call
    with the kernels' plain versions patched in, alternating plain, kernel,
    kernel, plain. Then one call under torch.profiler: wall time, summed
    device-kernel time from the trace, their ratio (the device's busy share
    while profiled), and the kernels by device time; the trace goes to
    build/traces/."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed()
    e2e = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        with plain_versions(which == "plain"):
            e2e[which].append(timed())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = timed()
    out_dir = os.path.join(root, "build", "traces")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"{label}.trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    by_kernel, copies = {}, 0
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"][:60]
            ms, count = by_kernel.get(name, (0.0, 0))
            by_kernel[name] = (ms + e["dur"] / 1e3, count + 1)
        elif e.get("cat") == "gpu_memcpy":
            copies += 1
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_kernel.values())
    return {"e2e_ms": e2e, "profiled_wall_ms": wall_ms,
            "device_kernel_ms": device_ms, "busy_share": device_ms / wall_ms,
            "kernel_launches": sum(c for _, c in by_kernel.values()),
            "memcpys": copies,
            "top": [dict(name=k, ms=ms, count=c) for k, (ms, c) in rows[:12]]}


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Route the model's operator products through the kernels' plain
    versions (autograd of plain PyTorch, forward and backward) while on."""
    from ndcn_tpu_torch.graph import sparse
    from ndcn_tpu_torch.kernels import bsr_spmm, coo_spmv, fused_rhs
    from ndcn_tpu_torch.models import ndcn
    from ndcn_tpu_torch.parallel import coo_shard
    from ndcn_tpu_torch.parallel.mesh import gather_rows

    def rowblock_plain(op, x, transpose):
        bl = op.block_t if transpose else op.block
        table = gather_rows(x, op.rows_per, op.group)
        return coo_spmv.coo_spmv_plain(
            bl.rows, bl.cols, bl.vals, table, bl.n,
            coo_spmv.GATHER_BF16 and x.shape[1] > 1)[:op.stop - op.start]

    def rowblock_T_plain(op, xT, transpose):
        bl = op.block_t if transpose else op.block
        table = gather_rows(xT.t(), op.rows_per, op.group)
        return coo_spmv.coo_spmv_T_plain(
            bl.rows, bl.cols, bl.vals, table.t(), bl.n,
            coo_spmv.GATHER_BF16)[:, :op.stop - op.start]

    saved = (sparse.coo_spmv, sparse.bsr_spmm, ndcn.fused_rhs,
             ndcn.bsr_fused_rhs, ndcn.spmv_T, coo_shard._block_product,
             coo_shard._block_product_T)
    if on:
        coo_shard._block_product = rowblock_plain
        coo_shard._block_product_T = rowblock_T_plain
        sparse.coo_spmv = lambda op, x: coo_spmv.coo_spmv_plain(
            op.rows, op.cols, op.vals, x, op.n,
            coo_spmv.GATHER_BF16 and x.shape[1] > 1)
        sparse.bsr_spmm = lambda a, at, x: bsr_spmm.bsr_spmm_plain(a, x)
        ndcn.fused_rhs = fused_rhs.fused_rhs_plain
        ndcn.bsr_fused_rhs = (lambda a, at, x, w, b:
                              bsr_spmm.bsr_fused_rhs_plain(a, x, w, b))
        ndcn.spmv_T = lambda op, xT: (
            coo_spmv.coo_spmv_T_wide_plain if coo_spmv.GATHER_WIDE
            else coo_spmv.coo_spmv_T_plain)(op.rows, op.cols, op.vals, xT,
                                            op.n, coo_spmv.GATHER_BF16)
    try:
        yield
    finally:
        (sparse.coo_spmv, sparse.bsr_spmm, ndcn.fused_rhs,
         ndcn.bsr_fused_rhs, ndcn.spmv_T, coo_shard._block_product,
         coo_shard._block_product_T) = saved


# the kernels by their device names in a replay's trace (K1 over A and
# over Aᵀ is one)
SCAN_KERNEL_NAMES = {"fused_rhs": r"(?<![a-z_])fused_rhs_kernel",
                     "bsr_fused_rhs": r"bsr_fused_rhs_kernel",
                     "bsr_spmm": r"bsr_spmm_kernel",
                     "coo_spmv": r"csr_rows_kernel"}


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def spread(ms) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "n": len(ms)}


def bounded_setting(dev, root: str, phase: str, label: str, op, vt, x0,
                    target, fused, max_steps: int, steps: int, needed,
                    method: str = "dopri5", adjoint: bool = False,
                    group=None, ref=None) -> dict:
    """One setting of [23] / [24]: three copies of one model trained
    ``steps`` steps from one init: the host loop, the eager bounded step
    and the graph (a ``TrainChunk`` of ``steps``), with CapturableAdam for
    the last two. Before each eager bounded step the host loop's forward
    runs at its weights (a fourth copy): the losses and NFE of the two
    solves are compared there, since runs trained apart part at the
    solver's discrete decisions (an accepted attempt more or less) once
    their last bits differ. ``group``: the operator is a row block of it
    (the loss and the gradients' sum over it). ``ref``: the CPU's first
    step (loss, gradients and the bar of each gradient), held against the
    eager bounded step's first."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.experiments import dynamics
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.train import budget as budget_lib
    from ndcn_tpu_torch.train.chunk import TrainChunk
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

    kw = dict(rtol=0.01, atol=0.001, method=method, adjoint=adjoint)
    where = f"{phase} {label}"

    def make(scan, capturable):
        model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=dev)
        opt = torch_adam(model.parameters(), 0.01, 1e-3,
                         capturable=capturable)
        grid = (torch.as_tensor(vt, dtype=torch.float32, device=dev)
                if scan else vt)

        def loss_fn():
            out, stats = ndcn_forward(model, op, grid, x0, fused=fused,
                                      max_steps=max_steps, scan=scan, **kw)
            loss_fn.nfe = stats.nfe
            loss_fn.stats = stats
            loss = dynamics.nan_unless_ok(
                stats.success, l1_loss(out[..., 0].T, target, group))
            return loss, loss / target.mean()

        def forward_stats():
            with torch.no_grad():
                return ndcn_forward(model, op, grid, x0, fused=fused,
                                    max_steps=max_steps, scan=scan,
                                    **dict(kw, adjoint=False))[1]

        return (model, opt, make_sgd_step(opt, loss_fn, group),
                forward_stats, loss_fn)

    _, _, host, st_host, _ = make(False, False)
    m_e, _, eager, st_eager, loss_e = make(True, True)
    m_g, o_g, graphed, _, _ = make(True, True)
    m_t, _, _, _, loss_t = make(False, False)
    sh, se = st_host(), st_eager()
    attempts = int(se.n_accepted) + int(se.n_rejected)
    check(int(se.nfe) == sh.nfe and bool(se.success)
          and attempts == sh.n_accepted + sh.n_rejected,
          f"{where}: the bounded solve's stats {se} part from the host "
          f"loop's {sh}")
    # K1 over Aᵀ: the backward's launches beyond the recomputation of every
    # attempt (all but the initial step's two evaluations); under the
    # adjoint every augmented evaluation is one over A and one over Aᵀ. On
    # a row block K1 counts apart.
    k1 = "coo_spmv" if group is None else "coo_spmv_rowblock"
    kernels.reset_launch_counts()
    loss, _ = loss_e()
    fwd = kernels.launch_counts()
    loss.backward()
    bwd = {k: v - fwd[k] for k, v in kernels.launch_counts().items()}
    transposed = (bwd[k1] // 2 if adjoint
                  else bwd[k1] - max(0, fwd[k1] - 2))
    check("coo_spmv" not in needed or transposed > 0,
          f"{where}: no K1 over Aᵀ in the backward ({fwd}, {bwd})")
    first = None
    if ref is not None:
        grads = [p.grad.detach().cpu() for p in m_e.parameters()]
        first = dict(loss_rel_l1_vs_cpu=abs(float(loss) - ref["loss"])
                     / abs(ref["loss"]),
                     grad_rel_l1_vs_cpu=[rel_l1(g, r) for g, r in
                                         zip(grads, ref["grads"])],
                     grad_bars=ref["bars"])
        check(first["loss_rel_l1_vs_cpu"] <= 1e-4 and all(
            e <= b for e, b in zip(first["grad_rel_l1_vs_cpu"],
                                   ref["bars"])),
              f"{where}: the first step parts from the CPU's: {first}")
    m_e.zero_grad(set_to_none=True)
    backward_nfe = ([int(b.nfe) for b in loss_e.stats.backward] if adjoint
                    else None)
    # the host loop and the eager bounded step, each loss read; the second
    # eager step's peak memory and launches (those the graph records)
    host_ms, host_losses = [], []
    for _ in range(steps):
        host_ms.append(wall_ms(lambda: host_losses.append(
            float(host()[0]))))
    eager_ms, eager_losses, eager_nfe = [], [], []
    forced_losses, forced_nfe = [], []
    for i in range(steps):
        with torch.no_grad():
            for a, b in zip(m_t.parameters(), m_e.parameters()):
                a.copy_(b)
            forced_losses.append(float(loss_t()[0]))
        forced_nfe.append(int(loss_t.nfe))
        if i != 1:
            eager_ms.append(wall_ms(lambda: eager_losses.append(
                float(eager()[0]))))
        else:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launch_counts()
            eager_losses.append(float(eager()[0]))
            per_step = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated(dev) - base
        eager_nfe.append(int(loss_e.nfe))
    step_bytes = budget_lib.scan_train_bytes(
        method, max_steps, torch.empty((x0.shape[0], 20), device="meta"))
    chunk = TrainChunk(graphed, m_g.parameters(), o_g, None, step_bytes)
    capture_s = time.perf_counter()
    chunk.capture()
    capture_s = time.perf_counter() - capture_s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_loss, _ = chunk(steps)
    chunk_ms = (time.perf_counter() - t0) * 1e3
    check(g_loss == eager_losses[-1] and all(
        torch.equal(a, b) for a, b in zip(m_g.parameters(),
                                          m_e.parameters())),
          f"{where}: the graphed steps part from the eager bounded steps "
          f"({g_loss} vs {eager_losses[-1]})")
    check(chunk.host_reads == 1 and chunk.replays == steps,
          f"{where}: {chunk.host_reads} host reads for {chunk.replays} "
          f"replays")
    gap = rel_l1(torch.tensor(eager_losses), torch.tensor(forced_losses))
    check(gap <= 1e-5 and eager_nfe == forced_nfe,
          f"{where}: the bounded steps' losses part from the host loop's at "
          f"the same weights by {gap} (NFE {eager_nfe} vs {forced_nfe}): "
          f"{eager_losses} vs {forced_losses}")
    apart = rel_l1(torch.tensor(eager_losses), torch.tensor(host_losses))
    replay_ms = [wall_ms(chunk.graph.replay) for _ in range(steps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = wall_ms(chunk.graph.replay)
    out_dir = os.path.join(root, "build", "traces")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"scan{phase.strip('[]')}_{label}"
                         ".trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        kernel_events = [e for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "X" and e.get("cat") == "kernel"]
    device_ms = sum(e["dur"] for e in kernel_events) / 1e3
    found = {k: sum(1 for e in kernel_events if re.search(pat, e["name"]))
             for k, pat in SCAN_KERNEL_NAMES.items()}
    for k in needed:
        check(found.get(k, 0) > 0, f"{where}: {k} was not launched inside "
              f"the replay (profiled kernels: {found})")
    chunk.release()
    return dict(
        method=method, adjoint=adjoint, max_steps=max_steps,
        attempts=attempts, nfe=sh.nfe, host_loop_nfe=sh.nfe,
        backward_nfe=backward_nfe, host_syncs_host_loop=sh.host_syncs,
        losses_bit_equal=True, loss_rel_l1_vs_host_loop=gap,
        nfe_per_step=eager_nfe, first_step_vs_cpu=first,
        loss_rel_l1_vs_host_loop_trained_apart=apart,
        host_reads_per_chunk=chunk.host_reads,
        gated_attempts=chunk.gated_attempts,
        step_ms=dict(host_loop=spread(host_ms),
                     eager_bounded=spread(eager_ms),
                     graph_replay=spread(replay_ms),
                     chunk_of_steps=chunk_ms / steps),
        capture_s=capture_s,
        profiled=dict(wall_ms=prof_wall, device_ms=device_ms,
                      busy_share=device_ms / prof_wall,
                      kernel_launches=len(kernel_events),
                      kernels_in_replay=found),
        k1_transposed_launches_per_step=transposed,
        peak_bytes_eager_step=peak, scan_train_bytes=step_bytes,
        launches_per_graphed_step={k: v for k, v in per_step.items() if v})


def scan_more_phase(dev, root: str, add_launches, big: dict) -> dict:
    """[24] the Adams family, the continuous adjoint and the mesh under
    ``--scan_chunk`` (see the module docstring): returns the phase's
    record, whose ``launches_per_graphed_step`` the kernels line takes."""
    import numpy as np
    import scipy.sparse as sp
    import torch.distributed as dist

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.experiments import dynamics
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.parallel import coo_shard
    from ndcn_tpu_torch.parallel.mesh import process_group
    from ndcn_tpu_torch.tools import smoke_references as sr

    t24 = time.perf_counter()
    refs = sr.load()
    problems, settings, per_graphed = {}, {}, {}
    names = ("enc1.weight", "enc1.bias", "enc2.weight", "enc2.bias",
             "wt.weight", "wt.bias", "dec.weight", "dec.bias")
    for label, needed, steps in (
            ("adams_dense", ["fused_rhs"], 2),
            ("explicit_adams_dense", ["fused_rhs"], 2),
            ("dopri5_adjoint_dense", ["fused_rhs"], 2),
            ("dopri5_adjoint_coo", ["coo_spmv"], 2),
            ("dopri5_adjoint_bsr", ["bsr_fused_rhs", "bsr_spmm"], 2),
            ("adams_adjoint_dense", ["fused_rhs"], 2)):
        fmt, fused, method, adjoint, tick, max_steps = \
            sr.SCAN_SETTINGS[label]
        if tick not in problems:
            lap, t_h, x0_h, target_h = sr.heat_replica_problem(tick)
            problems[tick] = (lap, t_h, x0_h.to(dev),
                              target_h[..., 0].T.contiguous().to(dev))
        lap, t_h, x0, target = problems[tick]
        op = as_operator(lap if fmt == "dense" else sp.csr_matrix(lap),
                         sparse=fmt != "dense", format=fmt, device=dev)
        grads = sr.step_grads(refs, f"scan/{label}")
        ref = dict(loss=float(refs[f"scan/{label}/loss"]),
                   grads=[grads[n] for n in names], bars=[1e-3] * len(names))
        settings[label] = rec = bounded_setting(
            dev, root, "[24]", label, op, t_h, x0, target, fused, max_steps,
            steps, needed, method=method, adjoint=adjoint, ref=ref)
        rec["time_tick"] = tick
        check(rec["nfe"] == int(refs[f"scan/{label}/nfe"]),
              f"[24] {label}: NFE {rec['nfe']} on the card, "
              f"{int(refs[f'scan/{label}/nfe'])} on the CPU")
        for k, v in rec["launches_per_graphed_step"].items():
            per_graphed.setdefault(k, {})[label] = v

    # (c) [10]'s 200k COO step on a row block over the one-rank NCCL world
    # group (every collective of the solve's norms and the gradients' sum
    # runs, and the graph records them), beside [23]'s unsharded one
    b = big
    target_b = b["target"][..., 0].T.contiguous()
    with process_group(dev):
        op_rb = coo_shard.shard_coo_at(b["op"], 1, 0, None)._replace(
            group=dist.group.WORLD)
        settings["200k_coo_mesh"] = rec = bounded_setting(
            dev, root, "[24]", "200k_coo_mesh", op_rb, b["t_train"],
            b["x0"], target_b, False, b["max_steps"], 2, ["coo_spmv"],
            group=dist.group.WORLD)
        launched = rec["launches_per_graphed_step"]
        check(launched.get("coo_spmv_rowblock", 0) > 0
              and not launched.get("coo_spmv", 0),
              f"[24] 200k_coo_mesh: the row-block step launched {launched}")
    for k, v in rec["launches_per_graphed_step"].items():
        per_graphed.setdefault(k, {})["200k_coo_mesh"] = v
    del target_b

    # the heat driver with --scan_chunk 3 for 6 iterations on the cut
    # grids: adams on dense at tick 20, the adjoint on COO at tick 6
    drivers = {}
    for label, extra, needed in (
            ("adams_dense", ["--method", "adams", "--max_steps", "48",
                             "--time_tick", "20", "--fused_kernel"],
             ["fused_rhs"]),
            ("dopri5_adjoint_coo", ["--method", "dopri5", "--adjoint",
                                    "--time_tick", "6", "--sparse",
                                    "--sparse_format", "coo"],
             ["coo_spmv"])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = dynamics.run("heat", dynamics.build_parser("heat").parse_args(
            ["--network", "grid", "--n", "400", "--niters", "6",
             "--test_freq", "3", "--scan_chunk", "3", *extra]))
        counts = add_launches(f"[24] the heat driver {label}", needed)
        sc = out["scan_chunk"]
        check(sc["host_reads"] == sc["chunks"] == 2 and sc["steps"] == 6
              and np.all(np.isfinite(out["train_losses"])),
              f"[24] the heat driver {label}: {out}")
        drivers[label] = dict(
            train_losses=out["train_losses"], max_steps=out["max_steps"],
            chunks=sc, seconds=time.perf_counter() - t0,
            launches={k: v for k, v in counts.items() if v})
    return dict(settings=settings, drivers=drivers,
                launches_per_graphed_step=per_graphed,
                seconds=time.perf_counter() - t24)


def scan_chunk_phase(dev, root: str, add_launches, big: dict) -> dict:
    """[23] the scan path and ``--scan_chunk`` (see the module docstring):
    returns the phase's record, whose ``launches_per_graphed_step`` the
    kernels line takes."""
    import numpy as np
    import scipy.sparse as sp

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.experiments import dynamics
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.tools import smoke_references
    from ndcn_tpu_torch.train import budget as budget_lib

    t23 = time.perf_counter()
    kw = dict(rtol=0.01, atol=0.001, method="dopri5")

    lap, t_h, x0_h, target_h = smoke_references.heat_replica_problem()
    x0 = x0_h.to(dev)
    target = target_h[..., 0].T.contiguous().to(dev)       # (n, T)
    settings, per_graphed = {}, {}
    for label, fmt, fused, needed in (
            ("grid400_dense", "dense", "auto", ["fused_rhs"]),
            ("grid400_bsr", "bsr", "auto", ["bsr_fused_rhs", "bsr_spmm"]),
            ("grid400_coo", "coo", False, ["coo_spmv"])):
        op = as_operator(lap if fmt == "dense" else sp.csr_matrix(lap),
                         sparse=fmt != "dense", format=fmt, device=dev)
        model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=dev)
        ms = budget_lib.probe_step_budget(
            lambda: ndcn_forward(model, op, t_h, x0, fused=fused,
                                 nondiff=True, max_steps=1 << 14, **kw)[1],
            floor=8, headroom=2.5, slack=4, quantum=4)
        settings[label] = rec = bounded_setting(
            dev, root, "[23]", label, op, t_h, x0, target, fused, ms, 5,
            needed)
        for k, v in rec["launches_per_graphed_step"].items():
            per_graphed.setdefault(k, {})[label] = v
    b = big
    target_b = b["target"][..., 0].T.contiguous()
    settings["200k_coo"] = rec = bounded_setting(
        dev, root, "[23]", "200k_coo", b["op"], b["t_train"], b["x0"],
        target_b, False, b["max_steps"], 5, ["coo_spmv"])
    for k, v in rec["launches_per_graphed_step"].items():
        per_graphed.setdefault(k, {})["200k_coo"] = v
    del target_b

    # the heat driver with --scan_chunk 10 for 20 iterations on each
    # operator; on dense with a budget cut below what the solve needs, so
    # that the first chunk runs out and the elastic rollback captures again
    drivers = {}
    real_probe = budget_lib.probe_step_budget
    for label, extra, needed, cut in (
            ("grid400_dense_rollback", ["--fused_kernel"], ["fused_rhs"],
             True),
            ("grid400_bsr", ["--fused_kernel", "--sparse", "--sparse_format",
                             "bsr"], ["bsr_fused_rhs", "bsr_spmm"], False),
            ("grid400_coo", ["--sparse", "--sparse_format", "coo"],
             ["coo_spmv"], False),
            ("lstm_gnn_coo", ["--baseline", "lstm_gnn", "--sparse",
                              "--sparse_format", "coo"], ["coo_spmv"],
             False)):
        if cut:
            budget_lib.probe_step_budget = lambda *a, **k: 2
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out = dynamics.run("heat", dynamics.build_parser(
                "heat").parse_args(
                ["--network", "grid", "--n", "400", "--method", "dopri5",
                 "--niters", "20", "--test_freq", "10", "--scan_chunk", "10",
                 *extra]))
        finally:
            budget_lib.probe_step_budget = real_probe
        counts = add_launches(f"[23] the heat driver {label}", needed)
        sc = out["scan_chunk"]
        check(sc["host_reads"] == sc["chunks"] and sc["steps"] == 20
              + 10 * out["elastic_retries"] and np.all(np.isfinite(
                  out["train_losses"])), f"[23] {label}: {out}")
        if cut:
            check(out["elastic_retries"] >= 1
                  and sc["captures"] == 1 + out["elastic_retries"],
                  f"[23] {label}: no rollback that captured again: {sc}, "
                  f"{out['elastic_retries']} rollbacks")
        drivers[label] = dict(
            train_losses=out["train_losses"], max_steps=out["max_steps"],
            elastic_retries=out["elastic_retries"], chunks=sc,
            seconds=time.perf_counter() - t0,
            launches={k: v for k, v in counts.items() if v})
    return dict(settings=settings, drivers=drivers,
                launches_per_graphed_step=per_graphed,
                seconds=time.perf_counter() - t23)


@contextlib.contextmanager
def gather_mode(wide: bool, bf16: bool):
    """``coo_spmv.GATHER_WIDE`` and ``GATHER_BF16`` for the body."""
    from ndcn_tpu_torch.kernels import coo_spmv

    saved = coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16
    coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = wide, bf16
    try:
        yield
    finally:
        coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = saved


def artifact_phase(dev, root: str, add_launches) -> dict:
    """[21] b, the artifacts with the Adams methods and the feature-major
    layout (see the module docstring), in the process of [21] a
    (``side_main``): the grid400 model at the oracle fixture's weights, the
    200k and 1M problems and models of [10] and [12] built again from
    their seeds. Returns the artifacts' records, the launches their
    serving process counted and each kernel's launches in one request."""
    import numpy as np

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.convert import params_from_jax
    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.graph.generators import (build_network,
                                                 build_sparse_graph)
    from ndcn_tpu_torch.graph.operators import (normalized_laplacian,
                                                normalized_laplacian_sparse)
    from ndcn_tpu_torch.graph.sparse import from_dense, from_scipy_coo
    from ndcn_tpu_torch.models import init_ndcn
    from ndcn_tpu_torch.serve import export_ndcn, make_server, save_artifact
    from ndcn_tpu_torch.tools.serve_artifact import host_reads
    from ndcn_tpu_torch.train.sampling import sample_times

    t21 = time.perf_counter()
    fx = dict(np.load(os.path.join(root, "tests", "fixtures",
                                   "ndcn_forward_grid400.npz")))
    model_grid = params_from_jax(
        {name: {"w": fx[f"{name}_w"].T, "b": fx[f"{name}_b"]}
         for name in ("enc1", "enc2", "wt", "dec")}, device=dev)
    op_grid = from_dense(normalized_laplacian(build_network("grid", 400)),
                         device=dev)
    op_big = from_scipy_coo(normalized_laplacian_sparse(
        build_sparse_graph(200_000, 10, seed=0)), device=dev)
    splits = sample_times(5.0, 40, "irregular", seed=0)
    model_big = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=dev)
    args_1m = large_graph.build_parser().parse_args(["--n", "1000000"])
    prob = large_graph.build_problem(args_1m, dev)
    model_1m = large_graph.new_model(args_1m, dev)
    kw20 = dict(rtol=0.01, atol=0.001, method="dopri5")
    served = {}
    # (b) the artifacts, served in a fresh process
    exp21 = os.path.join(root, "build", "smoke_export21")
    shutil.rmtree(exp21, ignore_errors=True)
    os.makedirs(exp21)
    args_1m_kw = dict(rtol=0.01, atol=0.001, method="dopri5", layout="auto")
    x0_200k = np.random.RandomState(0).uniform(
        0.0, 25.0, (op_big.n, 1)).astype(np.float32)
    settings21b = {  # model, operator, grid, forward kwargs, request,
        # wide gather, the kernels each RHS evaluation launches once
        **{f"grid400_dense_{m}": (model_grid, op_grid, fx["t"],
                                  dict(kw20, method=m, fused="auto"),
                                  fx["x0"], False, ["fused_rhs"])
           for m in ("adams", "fixed_adams", "explicit_adams")},
        "1m_coo_auto_feature_major": (
            model_1m, prob.op, prob.splits.t, args_1m_kw,
            prob.x0.cpu().numpy(), False, ["coo_spmv_T_pack", "coo_spmv_T"]),
        "200k_coo_feature_major_wide": (
            model_big, op_big, splits.t,
            dict(kw20, layout="feature_major"), x0_200k, True,
            ["coo_spmv_T_wide"]),
    }
    art21, served21 = {}, []
    for label, (mdl, op21, vt21, fkw, x0, wide, knames) in \
            settings21b.items():
        with gather_mode(wide, False):
            t0 = time.perf_counter()
            blob = export_ndcn(mdl, op21, vt21, x0.shape, **fkw)
            export_s = time.perf_counter() - t0
            path = os.path.join(exp21, f"{label}.pt2")
            save_artifact(path, blob)
            np.save(os.path.join(exp21, f"{label}_x0.npy"), x0)
            served21 += [path, os.path.join(exp21, f"{label}_x0.npy")]
            srv = make_server(mdl, op21, vt21, **fkw)
            kernels.reset_launch_counts()
            with host_reads() as srv_reads:
                out_s, ok_s = srv(x0)
            torch.cuda.synchronize()
            counts = add_launches(f"{label} in-process", knames)
            st = srv.last_stats
            check(ok_s, f"{label}: the server's solve failed")
            np.save(os.path.join(exp21, f"{label}_server.npy"),
                    out_s.cpu().numpy())
            srv_ms = []
            for _ in range(10):
                t0 = time.perf_counter()
                srv(x0)
                torch.cuda.synchronize()
                srv_ms.append((time.perf_counter() - t0) * 1e3)
        art21[label] = dict(
            bytes=len(blob), export_s=export_s, nfe_server=st.nfe,
            accepted=st.n_accepted, rejected=st.n_rejected,
            server_median_ms=statistics.median(srv_ms),
            server_host_reads=srv_reads[0],
            server_launch_counts={k: v for k, v in counts.items() if v})
        del blob, srv, out_s
        torch.cuda.empty_cache()
    r = subprocess.run(
        [sys.executable, "-m", "ndcn_tpu_torch.tools.serve_artifact",
         *served21, "--requests", "10", "--answers", exp21],
        capture_output=True, text=True, timeout=600, cwd=root)
    check(r.returncode == 0, f"serving the [21] artifacts failed: "
          f"{r.stderr[-3000:]}")
    recs21 = {os.path.splitext(rec["artifact"])[0]: rec for rec in
              map(json.loads, r.stdout.strip().splitlines())}
    for label, (*_, knames) in settings21b.items():
        rec, a = recs21[label], art21[label]
        check(rec["success"] and not rec["model_code_imported"],
              f"{label}: the artifact's solve failed or the serving process "
              f"imported {rec['model_code_imported']}")
        for name, c in rec["launch_counts"].items():
            served[name] = served.get(name, 0) + c
        got = np.load(os.path.join(exp21, f"{label}.npy"))
        ref = np.load(os.path.join(exp21, f"{label}_server.npy"))
        diff = float(np.abs(got - ref).max())
        rel = rel_l1(torch.as_tensor(got), torch.as_tensor(ref))
        # the adams artifact runs the masked machine against the server's
        # host-indexed solve; every other one the server's operations
        ok = rel <= 1e-5 if label.endswith("_adams") and "fixed" not in \
            label and "explicit" not in label else diff <= 1e-6
        check(ok, f"{label}: the artifact parts from the server by {diff} "
              f"max|Δ|, {rel} rel-L1")
        launched = {k: rec["launch_counts"].get(k, 0) for k in knames}
        # one launch of each kernel an RHS evaluation: the artifact's NFE
        check(all(v == a["nfe_server"] for v in launched.values()),
              f"{label}: launches {launched} in the artifact, NFE "
              f"{a['nfe_server']} in process")
        a.update(max_abs_diff=diff, rel_l1=rel, launches_per_request=launched,
                 median_ms=rec["median_ms"], latency_ms=rec["latency_ms"],
                 first_request_ms=rec["first_request_ms"],
                 load_s=rec["load_s"], host_reads=rec["host_reads"])
    shutil.rmtree(exp21, ignore_errors=True)
    per_request = dict(
        coo_spmv_T=art21["1m_coo_auto_feature_major"][
            "launches_per_request"]["coo_spmv_T"],
        coo_spmv_T_pack=art21["1m_coo_auto_feature_major"][
            "launches_per_request"]["coo_spmv_T_pack"],
        coo_spmv_T_wide=art21["200k_coo_feature_major_wide"][
            "launches_per_request"]["coo_spmv_T_wide"])
    return dict(artifacts=art21, served_launches=served,
                launches_in_artifact=per_request,
                seconds=time.perf_counter() - t21)


def timed_steps(step, k=5, warm=True) -> float:
    """Host-clock ms a call of ``step``, over ``k`` calls to
    ``torch.cuda.synchronize()``, after one warm call with ``warm``."""
    if warm:
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / k * 1e3


def replica_phase(dev, add_launches) -> dict:
    """[21] a, the Adams family and the continuous adjoint under replicas
    (see the module docstring), in a process of its own
    (``side_main``): the heat driver's grid400 data at each setting's tick
    from ``tools.smoke_references.heat_replica_problem``, the CPU's
    first steps from its committed references. Returns the settings'
    records; ``main`` adds [18]'s seconds a model-step beside each."""
    import numpy as np
    import scipy.sparse as sp

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.experiments.dynamics import build_parser, run
    from ndcn_tpu_torch.graph.generators import build_network
    from ndcn_tpu_torch.graph.operators import normalized_laplacian
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.ode import nan_unless
    from ndcn_tpu_torch.parallel.sweep import (make_ndcn_replica_train_step,
                                               replica_generators,
                                               replica_l1, stack_models)
    from ndcn_tpu_torch.tools import smoke_references
    from ndcn_tpu_torch.train.budget import sweep_memory_estimate
    from ndcn_tpu_torch.train.losses import l1_loss

    grid_lap = normalized_laplacian(build_network("grid", 400))
    problems = {}
    R21 = 4
    dense_f = ["--fused_kernel"]
    coo_f = ["--sparse", "--sparse_format", "coo"]
    bsr_f = ["--sparse", "--sparse_format", "bsr", "--fused_kernel"]
    settings21 = {   # format, driver flags, fused, method, adjoint, kernels
        "adams_dense": ("dense", dense_f, "auto", "adams", False,
                        ["fused_rhs_batched"]),
        "fixed_adams_dense": ("dense", dense_f, "auto", "fixed_adams", False,
                              ["fused_rhs_batched"]),
        "explicit_adams_dense": ("dense", dense_f, "auto", "explicit_adams",
                                 False, ["fused_rhs_batched"]),
        "dopri5_adjoint_dense": ("dense", dense_f, "auto", "dopri5", True,
                                 ["fused_rhs_batched"]),
        "dopri5_adjoint_coo": ("coo", coo_f, False, "dopri5", True,
                               ["coo_spmv_batched"]),
        "dopri5_adjoint_bsr": ("bsr", bsr_f, "auto", "dopri5", True,
                               ["bsr_fused_rhs_batched", "bsr_spmm_batched"]),
        "adams_adjoint_dense": ("dense", dense_f, "auto", "adams", True,
                                ["fused_rhs_batched"]),
    }

    def first_grads(op, fused, method, adjoint, seeds, device, problem):
        """The first step's losses and gradients of the heat driver's
        replica step over the replicas seeded ``seeds`` (one model when
        there is one seed), on ``device``, on ``problem`` (the grid, x0
        and the target)."""
        vt, x0, target = problem
        models = [init_ndcn(torch.Generator().manual_seed(s), 1, 20, 1)
                  for s in seeds]
        model = (stack_models(models) if len(seeds) > 1
                 else models[0]).to(device)
        out, stats = ndcn_forward(
            model, op, vt, x0.to(device), method=method, fused=fused,
            adjoint=adjoint, max_steps=256, rtol=0.01, atol=0.001)
        tgt = target.to(device)
        losses = (nan_unless(stats.success,
                             replica_l1(out.transpose(0, 1), tgt))
                  if len(seeds) > 1 else l1_loss(out, tgt).reshape(1))
        losses.sum().backward()
        return (losses.detach().cpu(),
                [p.grad.detach().cpu() for p in model.parameters()], stats)

    # the CPU's first steps (float32, and float64 on the unfused dense
    # route) are the committed references (tools/smoke_references.py)
    refs21 = smoke_references.load()
    check(R21 == smoke_references.R and {
        k: (v[0], v[2], v[3], v[4]) for k, v in settings21.items()}
        == smoke_references.REPLICA_SETTINGS,
        "[21]'s settings and the CPU references' differ")
    rep21 = {}
    for label, (fmt, flags, fused, method, adjoint, needed) in \
            settings21.items():
        mat = sp.csr_matrix(grid_lap) if fmt != "dense" else grid_lap
        op = as_operator(mat, sparse=fmt != "dense", format=fmt, device=dev)
        # the heat driver's data at tick 100 ([18]'s), or the CPU
        # references' own where the setting takes another tick
        tick = smoke_references.REPLICA_TIME_TICK.get(label, 100)
        if tick not in problems:
            _, vt_p, x0_p, target_p = smoke_references.heat_replica_problem(
                tick)
            problems[tick] = (vt_p, x0_p.to(dev), target_p.to(dev))
        heat21 = problems[tick]
        rec = {"time_tick": tick}
        # the heat driver: R = 4 replicas, 2 iterations
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run("heat", build_parser("heat").parse_args(
            ["--network", "grid", "--n", "400", "--method", method,
             "--niters", "2", "--test_freq", "2", "--replicas", str(R21),
             "--time_tick", str(tick), *flags,
             *(["--adjoint"] if adjoint else [])]))
        torch.cuda.synchronize()
        rec["driver_seconds"] = time.perf_counter() - t0
        rec["driver_launches"] = {k: v for k, v in add_launches(
            f"heat --replicas {R21} {label}", needed).items() if v}
        rec["final"], rec["max_steps"] = out["final"], out["max_steps"]
        check(all(np.isfinite(out["train_losses"][-1])),
              f"heat --replicas {R21} {label}: train losses "
              f"{out['train_losses']}")
        # the first step's losses and gradients: replica 0 against its run
        # alone on the card, the card against the CPU
        kernels.reset_launch_counts()
        loss_c, grads_c, st_c = first_grads(op, fused, method, adjoint,
                                            range(R21), dev, heat21)
        torch.cuda.synchronize()
        rec["step_launches"] = {k: v for k, v in
                                kernels.launch_counts().items() if v}
        check(all(rec["step_launches"].get(k, 0) > 0 for k in needed)
              and not any(v for k, v in rec["step_launches"].items()
                          if not k.endswith("batched")),
              f"{label}: the replica step launched {rec['step_launches']}")
        errs = []
        for i in (0,):
            loss_1, grads_1, _ = first_grads(op, fused, method, adjoint, [i],
                                             dev, heat21)
            errs.append(dict(
                loss=float(abs(loss_c[i] - loss_1[0]) / abs(loss_1[0])),
                grads=max(rel_l1(g[i], h) for g, h in zip(grads_c,
                                                          grads_1))))
        loss_h = torch.as_tensor(refs21[f"replicas/{label}/loss"])
        grads_h = smoke_references.replica_grads(refs21, label)
        nfe_h = refs21[f"replicas/{label}/nfe"].tolist()
        vs_cpu = dict(loss=float((loss_c - loss_h).abs().max()
                                 / loss_h.abs().max()),
                      grads=max(rel_l1(g, h) for g, h in zip(grads_c,
                                                             grads_h)))
        grad_bar = 1e-3
        over = max(vs_cpu["grads"], *(e["grads"] for e in errs)) > grad_bar
        if over or (method == "adams" and not adjoint):
            # backprop through adams's step-size and order controller
            # moves with float32's rounding (its NFE too): the bar is
            # twice the CPU's own float32-vs-float64 distance where that
            # is larger, as
            # [15] holds the other solvers' answers. For adams backprop
            # the card's float32 gradients are held against the same
            # float64 ones beside the CPU's: no farther from them
            grads_64 = smoke_references.replica_grads(refs21, label,
                                                      f64=True)
            vs_cpu["cpu_f32_vs_f64"] = max(
                rel_l1(g.double(), h) for g, h in zip(grads_h, grads_64))
            vs_cpu["card_f32_vs_f64"] = max(
                rel_l1(g.double(), h) for g, h in zip(grads_c, grads_64))
            if over:
                grad_bar = max(grad_bar, 2 * vs_cpu["cpu_f32_vs_f64"])
        check(all(e["loss"] <= 1e-4 and e["grads"] <= grad_bar
                  for e in errs)
              and vs_cpu["loss"] <= 1e-4 and vs_cpu["grads"] <= grad_bar,
              f"{label}: replica 0 against its run alone {errs}, the "
              f"card against the CPU {vs_cpu}")
        rec.update(first_step_vs_alone=errs, first_step_card_vs_cpu=vs_cpu,
                   nfe_replicas=list(st_c.nfe), nfe_cpu=nfe_h)
        if adjoint:
            rec["backward_nfe_replicas"] = [
                sum(b.nfe[i] for b in st_c.backward) for i in range(R21)]
            rec["backward_intervals"] = len(st_c.backward)
        # seconds a model-step, and the step's peak beside the memory
        # guard's estimate (one replica's probe step, times R)
        init_fn, step_fn = make_ndcn_replica_train_step(
            op, *heat21, method=method, fused=fused, adjoint=adjoint,
            max_steps=256)
        model, opt = init_fn(replica_generators(0, R21))
        one_model, one_opt = init_fn(replica_generators(0, 1))
        est = sweep_memory_estimate(lambda: step_fn(one_model, one_opt), R21,
                                    dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        # warm already: the first steps above ran the same programs
        ms = timed_steps(lambda: step_fn(model, opt), k=1, warm=False)
        rec["step_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                               - base) / 1e9
        rec["guard_estimate_gb"] = est["estimate"] / 1e9
        rec.update(batched_step_ms=ms, model_step_ms=ms / R21)
        rep21[label] = rec
        del model, opt, one_model, one_opt
        torch.cuda.empty_cache()
    return rep21


def heat_200k(op, splits, dev) -> dict:
    """[10]'s 200k training problem on ``op`` (the 200k / 2.2M normalized
    Laplacian): x0 from seed 0, the port's heat ground truth at rtol 1e-6
    / atol 1e-8 as the target, the train grid and the probed step budget
    (an init from seed 0, dopri5, hidden 20)."""
    import numpy as np

    from ndcn_tpu_torch.experiments.dynamics import heat_ground_truth
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.train.budget import probe_step_budget

    x0 = torch.as_tensor(np.random.RandomState(0).uniform(
        0.0, 25.0, (op.n, 1)).astype(np.float32), device=dev)
    t0 = time.perf_counter()
    truth, gt_stats = heat_ground_truth(op, x0, splits.t, rtol=1e-6,
                                        atol=1e-8)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    check(gt_stats.success, f"200k ground truth failed: {gt_stats}")
    t_train = splits.t[splits.id_train]
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1, device=dev)
    budget = probe_step_budget(
        lambda: ndcn_forward(model, op, t_train, x0, nondiff=True,
                             max_steps=1 << 14, rtol=0.01, atol=0.001,
                             method="dopri5")[1],
        floor=8, headroom=1.5, slack=2, quantum=4)
    return dict(op=op, t_train=t_train, x0=x0, target=truth[splits.id_train],
                max_steps=budget, gt_nfe=gt_stats.nfe, gt_seconds=gt_s)


def side_main(which: str, out_path: str) -> None:
    """A process of its own beside ``main`` (``python3 chip_smoke.py --side
    WHICH OUT``), which ``main`` starts once the phases that time a kernel
    or a library call ([3]-[19]) are done, and which runs beside [20]-[22]
    and [25]: every side is launch-bound on the host, and the smoke's time
    limit holds them only side by side. ``scan``: [23] and [24], on [10]'s
    200k problem rebuilt from the same seeds; ``replicas``: [21] a, then
    [21] b. It
    writes the records and the launches of their main-path runs to
    ``out_path``; a failed check exits non-zero."""
    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.kernels import build
    from ndcn_tpu_torch.kernels.platform import pin_fp32

    torch.set_num_threads(2)
    pin_fp32()
    build.load()
    dev = torch.device("cuda", 0)
    root = os.path.dirname(os.path.abspath(__file__))
    launches = dict.fromkeys(kernels.launch_counts(), 0)

    def add_launches(what: str, needed) -> dict:
        counts = kernels.launch_counts()
        for name in needed:
            check(counts[name] > 0, f"{what} never launched {name}")
        for name, c in counts.items():
            launches[name] += c
        return counts

    if which == "replicas":
        rec = dict(rep21=replica_phase(dev, add_launches))
        torch.cuda.empty_cache()
        rec["art21"] = artifact_phase(dev, root, add_launches)
        for name, c in rec["art21"].pop("served_launches").items():
            launches[name] += c
    else:
        from ndcn_tpu_torch.graph.generators import build_sparse_graph
        from ndcn_tpu_torch.graph.operators import \
            normalized_laplacian_sparse
        from ndcn_tpu_torch.graph.sparse import from_scipy_coo
        from ndcn_tpu_torch.train.sampling import sample_times

        op = from_scipy_coo(normalized_laplacian_sparse(
            build_sparse_graph(200_000, 10, seed=0)), device=dev)
        big = heat_200k(op, sample_times(5.0, 40, "irregular", seed=0), dev)
        scan23 = scan_chunk_phase(dev, root, add_launches, big)
        torch.cuda.empty_cache()
        scan24 = scan_more_phase(dev, root, add_launches, big)
        rec = dict(scan23=scan23, scan24=scan24)
    with open(out_path, "w") as f:
        json.dump(dict(rec, launches=launches), f)


class SideProcess:
    """``side_main(which, ...)`` started in a process of its own, its output
    to ``build/smoke_side_<which>.log`` (one stream stays the smoke's); it
    is stopped at exit whatever happens in ``main``."""

    def __init__(self, which: str, root: str):
        self.which = which
        self.out = os.path.join(root, "build", f"smoke_side_{which}.json")
        self.log = open(os.path.join(root, "build",
                                     f"smoke_side_{which}.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", which,
             self.out], cwd=root, stdout=self.log, stderr=subprocess.STDOUT)
        atexit.register(lambda: self.proc.poll() is None and self.proc.kill())

    def result(self, timeout: float = 600) -> dict:
        rc = self.proc.wait(timeout=timeout)
        self.log.close()
        with open(self.log.name) as f:
            tail = f.read()[-3000:]
        check(rc == 0, f"the {self.which} process exited {rc}: {tail}")
        with open(self.out) as f:
            rec = json.load(f)
        os.remove(self.out)
        return rec


TOOLS_LEVELS = ("spmv_ms", "rhs_ms", "fwd_while_ms", "fwd_scan_ms", "grad_ms",
                "step_ms")


def tools_phase(dev, root: str, add_launches, nfe10: int, smi: str) -> dict:
    """[25] the scale-record tools, ``analyze_mesh_tax`` and the quickstart
    on the card (see the module docstring): ``nfe10`` is [10]'s first
    host-loop step's NFE at the same weights, ``smi`` the card's
    ``nvidia-smi`` line. Returns the phase's record."""
    import tempfile

    import numpy as np

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.experiments import quickstart
    from ndcn_tpu_torch.tools import (analyze_mesh_tax, profile_scale_step,
                                      record_showcase)

    t25 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_tools_",
                           dir=os.path.join(root, "build"))
    rec = {}
    # (b) bench_scale at 200k, 5 iterations, in a process of its own
    # beside (a) and (c)-(e)
    bench_out = os.path.join(tmp, "scale_200k_heat.json")
    bench_log = open(os.path.join(tmp, "bench_scale.log"), "w")
    bench = subprocess.Popen(
        [sys.executable, "-m", "ndcn_tpu_torch.tools.bench_scale", "--n",
         "200000", "--iters", "5", "--repeats", "1", "--out", bench_out],
        cwd=root, stdout=bench_log, stderr=subprocess.STDOUT)
    atexit.register(lambda: bench.poll() is None and bench.kill())
    # (a) the step by level at 200k: [10]'s problem and weights, fp32
    # gather
    kernels.reset_launch_counts()
    prof = profile_scale_step.profile(profile_scale_step.build_parser()
                                      .parse_args(["--n", "200000",
                                                   "--kernel_precision",
                                                   "split2"]))
    prof["launches"] = {k: v for k, v in add_launches(
        "profile_scale_step at 200k", ["coo_spmv"]).items() if v}
    check(prof["nfe"] == nfe10, f"profile_scale_step's nfe {prof['nfe']} "
          f"against [10]'s {nfe10}")
    check(prof["resolved_layout"] == "nd"
          and all(prof[k] > 0 for k in TOOLS_LEVELS),
          f"profile_scale_step at 200k: {prof}")
    rec["profile_scale_step_200k"] = prof
    # (c) analyze_mesh_tax at 200k on a one-rank NCCL group
    kernels.reset_launch_counts()
    tax = analyze_mesh_tax.main(
        ["--n", "200000", "--variants", "step_u,step_s,fwd_u,fwd_s",
         "--kernel_precision", "split2", "--time", "--reps", "2", "--hist",
         os.path.join(tmp, "tax")])
    add_launches("analyze_mesh_tax at 200k", ["coo_spmv",
                                              "coo_spmv_rowblock"])
    v = tax["variants"]
    for whole, sharded in (("step_u", "step_s"), ("fwd_u", "fwd_s")):
        check(v[sharded]["nfe"] == v[whole]["nfe"]
              and abs(v[sharded]["loss"] - v[whole]["loss"])
              <= 1e-5 * abs(v[whole]["loss"]),
              f"analyze_mesh_tax: {sharded} against {whole}: {v}")
        check(v[sharded]["port_launches"].get("coo_spmv_rowblock", 0) > 0
              and not v[sharded]["port_launches"].get("coo_spmv")
              and v[whole]["port_launches"].get("coo_spmv", 0) > 0,
              f"analyze_mesh_tax's histograms: {sharded} "
              f"{v[sharded]['port_launches']}, {whole} "
              f"{v[whole]['port_launches']}")
        check(v[sharded]["kernel_launches"] > 0, f"{sharded}: no device "
              f"kernel in its histogram")
    rec["analyze_mesh_tax_200k"] = tax
    # (d) record_showcase on cora, 4 batched replicas, 20 epochs
    kernels.reset_launch_counts()
    show = record_showcase.main(
        ["--dataset", "cora", "--batch_iters", "--iter", "4", "--epochs",
         "20", "--out", os.path.join(tmp, "showcase_cora_4.json")])
    add_launches("record_showcase", [])
    check(show["card"] == smi and show["n_models"] == 4
          and len(show["per_iter_acc"]) == 4
          and np.isfinite(show["acc_mean"]),
          f"record_showcase's record: {show}")
    rec["record_showcase"] = {k: show[k] for k in (
        "acc_mean", "acc_std", "per_iter_acc", "total_time_s", "card")}
    # (e) the quickstart, 50 iterations (K2 under fused="auto")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    qs = quickstart.main(iters=50, platform="gpu", every=10)
    qs["seconds"] = time.perf_counter() - t0
    qs["launches"] = {k: c for k, c in add_launches(
        "the quickstart", ["fused_rhs"]).items() if c}
    check(all(np.isfinite(qs["loss"])) and qs["loss"][-1] < qs["loss"][0],
          f"the quickstart's loss did not fall: {qs}")
    rec["quickstart"] = qs
    # (b) again: bench_scale's record
    rc = bench.wait(timeout=600)
    bench_log.close()
    with open(bench_log.name) as f:
        tail = f.read()[-3000:]
    check(rc == 0, f"bench_scale exited {rc}: {tail}")
    with open(bench_out) as f:
        scale = json.load(f)
    check(set(scale) == {"measured", "estimate", "argv", "wall_s", "card",
                         "runs_steps_per_sec"}
          and scale["card"] == smi
          and scale["runs_steps_per_sec"] == [
              scale["measured"]["train_steps_per_sec"]]
          and scale["measured"]["iters"] == 5
          and scale["measured"]["n_nodes"] == 200_000
          and scale["estimate"]["n_nodes"] == 200_000
          and scale["measured"]["train_steps_per_sec"] > 0,
          f"bench_scale's record: {scale}")
    rec["bench_scale_200k"] = dict(
        wall_s=scale["wall_s"], card=scale["card"],
        train_steps_per_sec=scale["measured"]["train_steps_per_sec"],
        estimate_gb=scale["estimate"]["estimate_gb"],
        hbm_peak_gb=scale["measured"]["hbm_peak_gb"])
    shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t25
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a "
              "GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import scipy.sparse as sp

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.convert import params_from_jax
    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.experiments.dynamics import (build_parser,
                                                     ground_truth,
                                                     heat_ground_truth, run)
    from ndcn_tpu_torch.graph.generators import (build_network,
                                                 build_sparse_graph,
                                                 grid_block_initial_value)
    from ndcn_tpu_torch.graph.operators import (normalized_laplacian,
                                                normalized_laplacian_sparse)
    from ndcn_tpu_torch.graph.sparse import (as_operator, from_dense,
                                             from_scipy_coo)
    from ndcn_tpu_torch.kernels import (build, bsr_spmm, coo_mutual,
                                        coo_spmv, fused_rhs, sparse_bench)
    from ndcn_tpu_torch.kernels.platform import device_report, pin_fp32
    from ndcn_tpu_torch.graph.sparse import DenseGraph
    from ndcn_tpu_torch.models import init_ndcn, ndcn, ndcn_forward
    from ndcn_tpu_torch.serve import make_server
    from ndcn_tpu_torch.train.budget import probe_step_budget
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam
    from ndcn_tpu_torch.train.sampling import sample_times
    from ndcn_tpu_torch.tools import smoke_references

    root = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda", 0)

    def cuda_ms(fn, warmup: int = 3, iters: int = 25) -> float:
        """Median CUDA-event time of one call, after warm-up."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def queued_ms(fn, batch: int = 10, iters: int = 7) -> float:
        """Median device time of one call when the card never waits for the
        host: ``batch`` calls are enqueued behind a spin kernel (~2 ms, or
        three times what the host took to enqueue a batch, if that is more),
        and the events bracket their back-to-back run. ``cuda_ms`` brackets
        one call on an idle card, so for a kernel shorter than its wrapper's
        host work (tens of µs) it reads the host's time; this reads the
        card's."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin = max(4_000_000, int(3 * host_s * 2e9))
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / batch)
        return statistics.median(times)

    def serve_all(server, requests, what):
        """Answer each request, timing it to the end of its device work;
        returns the per-request records and the first answer."""
        answers, first = [], None
        for x0 in requests:
            t0 = time.perf_counter()
            out, ok = server(x0)
            torch.cuda.synchronize()
            lat = time.perf_counter() - t0
            st = server.last_stats
            check(ok and bool(torch.isfinite(out).all()),
                  f"{what} request failed: {st}")
            first = out if first is None else first
            answers.append(dict(latency_ms=lat * 1e3, nfe=st.nfe,
                                accepted=st.n_accepted,
                                rejected=st.n_rejected,
                                host_syncs=st.host_syncs))
        return answers, first

    # each phase's wall seconds, printed before the records: where the
    # smoke's time limit goes
    clock = {"at": time.perf_counter(), "phase": "1", "seconds": {}}

    def mark_phase(phase: str) -> None:
        now = time.perf_counter()
        clock["seconds"][clock["phase"]] = now - clock["at"]
        clock.update(at=now, phase=phase)

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    pin_fp32()
    report = device_report()
    check(report["sm90"], f"the kernels need compute capability 9.0: {report}")
    print(f"[1] device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{report['name']} sm_{report['capability'][0]}"
          f"{report['capability'][1]}, TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi)

    mark_phase("2")
    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    log = lib_path.with_name(lib_path.name + ".log").read_text()
    regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
            if "Used" in line and "registers" in line]
    print(f"[2] build: {build_s:.3f} s for {[p.name for p in build.sources()]}"
          f" -> {lib_path.relative_to(root)}; ptxas: {regs}")

    mark_phase("3")
    # ---- 3. K1 against its plain version
    t0 = time.perf_counter()
    adj = build_sparse_graph(200_000, 10, seed=0)
    lap = normalized_laplacian_sparse(adj)
    op_big = from_scipy_coo(lap, device=dev)
    host_build_s = time.perf_counter() - t0

    def max_rel(y, ref):
        err = float((y - ref).abs().max())
        return err, err / max(float(ref.abs().max()), 1e-30)

    csr_tensors = {}

    def library_csr(o, bf16=False):
        """A as a ``torch.sparse_csr_tensor`` (values rounded to bf16 with
        ``bf16``) for the library yardstick, built once per operator."""
        key = (o.vals.data_ptr(), bf16)
        if key not in csr_tensors:
            vals = coo_spmv.round_bf16(o.vals) if bf16 else o.vals
            csr_tensors[key] = torch.sparse_csr_tensor(
                o.row_ptr, o.cols, vals, size=(o.n, o.n))
        return csr_tensors[key]

    def spmv_record(what, o, d, kern, plain, library, state):
        """One SpMV form on one operator: the kernel against its plain
        version (<= 1e-5), two calls bit-equal, the library call on the same
        inputs (<= 1e-5 too: it computes the same function), the three
        median times and the bound from the bytes of A, the state and the
        result. Returns (record, kernel output)."""
        y, ref, lib = kern(), plain(), library()
        torch.cuda.synchronize()
        err, rel = max_rel(y, ref)
        check(rel <= 1e-5, f"{what} disagrees with its plain version: {rel}")
        check(torch.equal(y, kern()), f"{what}: two calls differ")
        check(max_rel(lib, ref)[1] <= 1e-5,
              f"{what}: the library call computes something else")
        nnz = int(o.cols.shape[0])
        rec = dict(max_abs_err=err, rel_err=rel, repeat_equal=True,
                   ms=cuda_ms(kern, iters=15), device_ms=queued_ms(kern),
                   library_device_ms=queued_ms(library),
                   plain_ms=cuda_ms(plain, iters=15),
                   library_ms=cuda_ms(library, iters=15),
                   **bound(nbytes(o.row_ptr, o.cols, o.vals, state, y),
                           2 * nnz * d))
        return rec, y

    def k1_case(op, d, seed):
        x = torch.as_tensor(np.random.RandomState(seed).randn(op.n, d)
                            .astype(np.float32), device=dev)
        a = library_csr(op)
        rec, _ = spmv_record(
            f"K1 n={op.n} d={d}", op, d, lambda: coo_spmv.coo_spmv(op, x),
            lambda: coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x,
                                            op.n),
            lambda: torch.sparse.mm(a, x), x)
        return dict(n=op.n, nnz=int(op.cols.shape[0]), d=d, **rec)

    k1_main = k1_case(op_big, 20, 1)
    k1_d1 = k1_case(op_big, 1, 2)
    rng = np.random.RandomState(3)
    n_hub, m = 20_000, 200_000
    rows = np.concatenate([rng.zipf(1.5, m) % n_hub,
                           np.full(5_000, 7)])       # row 7: a 5k-edge hub
    cols = np.concatenate([rng.randint(0, n_hub, m),
                           rng.choice(n_hub, 5_000, replace=False)])
    hub = sp.coo_matrix((rng.randn(rows.size).astype(np.float32),
                         (rows, cols)), shape=(n_hub, n_hub)).tocsr()
    hub.sum_duplicates()
    op_hub = from_scipy_coo(hub, device=dev)
    k1_hub = k1_case(op_hub, 20, 4)
    k1_hub["max_row_degree"] = int(np.diff(hub.indptr).max())
    k1_hub["split_rows"] = int(op_hub.split.long_rows.shape[0])
    k1_hub["chunks"] = int(op_hub.split.chunk_bounds.shape[0])
    check(k1_hub["max_row_degree"] >= 4_000 and k1_hub["chunks"] > 0,
          "hub graph has no hub row")
    print(f"[3] K1 coo_spmv vs plain (host graph build {host_build_s:.3f} s): "
          + json.dumps({"200k_d20": k1_main, "200k_d1": k1_d1,
                        "hub_d20": k1_hub}))

    mark_phase("4")
    # ---- 4. K2 against its plain version, and the fused-vs-unfused sweep
    def routes(kind, op, width, n, seed):
        """One shape of the ``fused_profitable`` sweep: ``ode_func`` with the
        fused kernel and with the route it takes otherwise (``matvec`` +
        ``linear_apply`` + relu), same model and state; whether 'auto'
        picks the route that was no slower on an idle card."""
        model = init_ndcn(torch.Generator().manual_seed(seed), 1, width, 1,
                          device=dev)
        h = torch.as_tensor(np.random.RandomState(seed).rand(n, width)
                            .astype(np.float32), device=dev)
        with torch.no_grad():
            def fused():
                return ndcn.ode_func(model, op, 0.0, h, fused=True)

            def unfused():
                return ndcn.ode_func(model, op, 0.0, h, fused=False)

            check(max_rel(fused(), unfused())[1] <= 1e-5,
                  f"the two routes of ode_func disagree ({kind}, {n}, {width})")
            rec = dict(kind=kind, n=n, width=width, fused_ms=cuda_ms(fused),
                       unfused_ms=cuda_ms(unfused),
                       fused_device_ms=queued_ms(fused),
                       unfused_device_ms=queued_ms(unfused))
        rec["auto_fuses"] = ndcn.fused_profitable(kind, width, n)
        # decided on the card's part alone (ten calls behind the spin
        # kernel, which repeats to 2 %): the idle-card ms of calls this
        # short is mostly the host's time and varies by tens of percent.
        # Within ROUTE_TIE the two routes count as tied and either may be
        # picked.
        fused_over_unfused = rec["fused_device_ms"] / rec["unfused_device_ms"]
        rec["fused_no_slower"] = fused_over_unfused <= 1.0
        rec["tie"] = 1.0 / ROUTE_TIE <= fused_over_unfused <= ROUTE_TIE
        rec["picked_over_other"] = (fused_over_unfused if rec["auto_fuses"]
                                    else 1.0 / fused_over_unfused)
        return rec

    def check_routes(records):
        """'auto' picks no route more than ROUTE_TIE slower than the other
        (checked once the whole sweep is printed)."""
        slower = [r for r in records if r["picked_over_other"] > ROUTE_TIE]
        check(not slower, f"fused_profitable picks the slower route: "
              f"{slower}")

    def k2_case(n, k, seed, sweep=False):
        r = np.random.RandomState(seed)
        a = torch.as_tensor(r.rand(n, n).astype(np.float32), device=dev)
        h = torch.as_tensor(r.rand(n, k).astype(np.float32), device=dev)
        w = torch.as_tensor(r.randn(k, k).astype(np.float32), device=dev)
        b = torch.as_tensor(r.randn(k).astype(np.float32), device=dev)

        def kern():
            return fused_rhs.fused_rhs(a, h, w, b)

        y = kern()
        ref = fused_rhs.fused_rhs_plain(a, h, w, b)
        emu = fused_rhs.fused_rhs_split_plain(a, h, w, b)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        check(torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * scale),
              f"K2 disagrees at ({n}, {k})")
        check(torch.equal(y, kern()), f"K2 ({n}, {k}): two calls differ")
        out = dict(n=n, k=k, max_abs_err=float((y - ref).abs().max()),
                   rel_err=max_rel(y, ref)[1], repeat_equal=True,
                   rel_err_vs_split_emulation=max_rel(y, emu)[1],
                   plan=fused_rhs.fused_rhs_plan(n, k)._asdict())
        check(out["rel_err_vs_split_emulation"] <= 2e-6,
              f"K2 ({n}, {k}) is not the split product: {out}")
        del emu
        out["ms"] = cuda_ms(kern)
        out["device_ms"] = queued_ms(kern)
        out["plain_ms"] = cuda_ms(lambda: fused_rhs.fused_rhs_plain(a, h, w, b))
        out["library_ms"] = cuda_ms(
            lambda: torch.relu(torch.addmm(b, a @ h, w)))
        out["library_device_ms"] = queued_ms(
            lambda: torch.relu(torch.addmm(b, a @ h, w)))
        out.update(bound(nbytes(a, h, w, b, h), 2 * n * n * k + 2 * n * k * k,
                         "split_tf32"))
        if sweep:
            out["routes"] = routes("dense", DenseGraph(a), k, n, seed)
        return out

    k2_main = k2_case(400, 20, 5)
    k2_ragged = k2_case(275, 13, 6)
    sweep = {f"{n}x{k}": k2_case(n, k, 7, sweep=True)
             for n in (400, 1000, 4000, 10000) for k in (20, 64, 128)}
    torch.cuda.empty_cache()
    print("[4] K2 fused_rhs vs plain: "
          + json.dumps({"400x20": k2_main, "275x13": k2_ragged,
                        "sweep": sweep}))
    check_routes([c["routes"] for c in sweep.values()])

    mark_phase("5")
    # ---- 5. serve the 400-node grid, dense operator, fused="auto"
    kernels.reset_launch_counts()
    fx = dict(np.load(os.path.join(root, "tests", "fixtures",
                                   "ndcn_forward_grid400.npz")))
    tree = {name: {"w": fx[f"{name}_w"].T, "b": fx[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    model = model_grid = params_from_jax(tree, device=dev)
    op_grid = from_dense(normalized_laplacian(build_network("grid", 400)),
                         device=dev)
    serve_kw = dict(rtol=0.01, atol=0.001, method="dopri5", fused="auto")
    server = make_server(model, op_grid, fx["t"], **serve_kw)
    rs = np.random.RandomState(11)
    requests = [fx["x0"]] + [rs.uniform(0.0, 25.0, (400, 1)).astype(np.float32)
                             for _ in range(2)]
    answers, first = serve_all(server, requests, "grid400")
    requests_grid = requests                  # [15] serves them again
    grid_err = rel_l1(first.cpu(), torch.as_tensor(fx["out"]))
    check(grid_err <= 1e-4, f"grid400 answer off the oracle: {grid_err}")
    check(fused_rhs.LAUNCHES > 0, "grid400 serving never launched K2")
    print("[5] serve grid400 dense fused=auto: "
          + json.dumps({"rel_l1_vs_oracle": grid_err,
                        "k2_launches": fused_rhs.LAUNCHES,
                        "requests": answers}))

    mark_phase("6")
    # ---- 6. serve the 200k-node COO graph
    splits = sample_times(5.0, 40, "irregular", seed=0)
    gen = torch.Generator().manual_seed(0)
    model_big = init_ndcn(gen, 1, 20, 1, device=dev)
    server_big = make_server(model_big, op_big, splits.t, **serve_kw)
    requests = [np.random.RandomState(s).uniform(0.0, 25.0, (op_big.n, 1))
                .astype(np.float32) for s in (0, 1, 2)]
    torch.cuda.reset_peak_memory_stats(dev)
    answers, first = serve_all(server_big, requests, "200k")
    check(first.shape == (len(splits.t), op_big.n, 1),
          f"200k answer has shape {tuple(first.shape)}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = kernels.launch_counts()
    check(coo_spmv.LAUNCHES > 0, "200k serving never launched K1")

    t0 = time.perf_counter()
    server_cpu = make_server(copy.deepcopy(model_big).cpu(),
                             from_scipy_coo(lap), splits.t, **serve_kw)
    out_cpu, ok_cpu = server_cpu(requests[0])
    cpu_s = time.perf_counter() - t0
    gpu_cpu = rel_l1(first.cpu(), out_cpu)
    check(ok_cpu and gpu_cpu <= 1e-4, f"200k GPU vs CPU: {gpu_cpu}")
    print("[6] serve 200k COO: " + json.dumps(
        {"nodes": op_big.n, "edges": k1_main["nnz"], "T": len(splits.t),
         "k1_launches": coo_spmv.LAUNCHES, "peak_allocated_gb": peak_gb,
         "requests": answers, "rel_l1_gpu_vs_cpu": gpu_cpu,
         "cpu_nfe": server_cpu.last_stats.nfe, "cpu_seconds": cpu_s}))

    main_launches = dict(launches)   # the main paths' launches, summed

    def add_launches(what: str, needed) -> dict:
        """Read the counts after a main-path phase, fail on a kernel of the
        path that never launched, and add them to the record."""
        counts = kernels.launch_counts()
        for name in needed:
            check(counts[name] > 0, f"{what} never launched {name}")
        for name, c in counts.items():
            main_launches[name] += c
        return counts

    mark_phase("7")
    # ---- 7. backward and BSR kernels against their plain versions
    def grads_of(fn, ins, g):
        """(outputs of fn, a timed closure of the backward alone)."""
        ins = [t.detach().clone().requires_grad_() for t in ins]
        out = fn(*ins)
        return (out, torch.autograd.grad(out, ins, g, retain_graph=True),
                lambda: torch.autograd.grad(out, ins, g, retain_graph=True))

    def compare(what, got, ref, ms, plain_ms, **extra):
        errs = [max_rel(a, b) for a, b in zip(got, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        check(rel <= 1e-5, f"{what} disagrees with its plain version: {rel}")
        return dict(extra, max_abs_err=err, rel_err=rel, ms=ms,
                    plain_ms=plain_ms)

    g_hub = torch.as_tensor(np.random.RandomState(8).randn(op_hub.n, 20)
                            .astype(np.float32), device=dev)
    hub_t = op_hub.transpose()
    a_hub_t = library_csr(hub_t)
    k1t, _ = spmv_record(
        "K1T", hub_t, 20, lambda: coo_spmv.coo_spmv(hub_t, g_hub),
        lambda: coo_spmv.coo_spmv_plain(hub_t.rows, hub_t.cols, hub_t.vals,
                                        g_hub, hub_t.n),
        lambda: torch.sparse.mm(a_hub_t, g_hub), g_hub)
    k1t.update(n=op_hub.n, d=20)
    # and through autograd: the backward of K1 is K1ᵀ
    x_hub = torch.as_tensor(np.random.RandomState(16).randn(op_hub.n, 20)
                            .astype(np.float32), device=dev)
    _, dx, _ = grads_of(lambda x: coo_spmv.coo_spmv(op_hub, x), [x_hub], g_hub)
    _, dx_ref, _ = grads_of(lambda x: coo_spmv.coo_spmv_plain(
        op_hub.rows, op_hub.cols, op_hub.vals, x, op_hub.n), [x_hub], g_hub)
    k1t["autograd_rel_err"] = max_rel(dx[0], dx_ref[0])[1]
    check(k1t["autograd_rel_err"] <= 1e-5, "K1's autograd backward is off")

    r = np.random.RandomState(9)
    k2_ins = [torch.as_tensor(v, device=dev) for v in (
        r.rand(400, 400).astype(np.float32), r.rand(400, 20).astype(np.float32),
        r.randn(20, 20).astype(np.float32), r.randn(20).astype(np.float32))]
    a_k2 = k2_ins[0]
    g_k2 = torch.as_tensor(r.randn(400, 20).astype(np.float32), device=dev)
    out_k2 = fused_rhs.fused_rhs(*k2_ins)
    got = fused_rhs.fused_rhs_backward(a_k2, k2_ins[1], k2_ins[2], out_k2,
                                       g_k2)[1:]
    _, ref, plain_bwd = grads_of(
        lambda h, w, b: fused_rhs.fused_rhs_plain(a_k2, h, w, b),
        k2_ins[1:], g_k2)
    def k2_bwd():
        return fused_rhs.fused_rhs_backward(a_k2, k2_ins[1], k2_ins[2],
                                            out_k2, g_k2)

    k2b = compare("K2 backward", got, ref, cuda_ms(k2_bwd),
                  cuda_ms(plain_bwd), n=400, k=20, library_ms=None,
                  device_ms=queued_ms(k2_bwd),
                  **bound(nbytes(a_k2, *k2_ins[1:3], out_k2, g_k2, *got),
                          4 * 400 * 400 * 20 + 4 * 400 * 20 * 20))

    grid_lap = normalized_laplacian(build_network("grid", 400))
    rand2k = (r.rand(2000, 2000) * (r.rand(2000, 2000) < 0.05)) \
        .astype(np.float32)

    def bsr_library(m):
        """(x -> A·x by one PyTorch call, its name) for the BSR matrix m: a
        ``torch.sparse_bsr_tensor`` product where this PyTorch runs one on
        the card, else the dense ``torch.matmul``. Neither is used by the
        port."""
        B = m.block
        rows_p, cols_p = m.n_row_blocks * B, -(-m.n_cols // B) * B
        try:
            a = torch.sparse_bsr_tensor(m.row_ptr, m.block_cols, m.blocks,
                                        size=(rows_p, cols_p))
            a @ torch.zeros((cols_p, 8), device=dev)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError):
            dense = torch.zeros((rows_p, cols_p), device=dev)
            for rb, cb, blk in zip(m.block_rows.tolist(),
                                   m.block_cols.tolist(), m.blocks):
                dense[rb * B:(rb + 1) * B, cb * B:(cb + 1) * B] = blk
            dense = dense[:m.n_rows, :m.n_cols].contiguous()
            return (lambda x: dense @ x), "torch.matmul (dense A)"
        pad = cols_p - m.n_cols
        return (lambda x: (a @ torch.nn.functional.pad(x, (0, 0, 0, pad)))
                [:m.n_rows]), "torch.sparse_bsr_tensor @"

    def bsr_bound(m, d, *more, products=1, dense_products=0, kind="fp32"):
        """Bound of ``products`` BSR products at width d and
        ``dense_products`` (n, d) × (d, d) ones in arithmetic ``kind``, over
        m's arrays, ``more`` tensors and nothing else."""
        B, nnzb = m.block, int(m.blocks.shape[0])
        return bound(nbytes(m.row_ptr, m.block_cols, m.blocks, *more),
                     products * 2 * nnzb * B * B * d
                     + dense_products * 2 * m.n_rows * d * d, kind)

    def k3_case(mat, d, seed):
        """K3 and K3 over Aᵀ against the plain version (<= 1e-5) and the
        emulation of its split-TF32 product (<= 2e-6), bit-equal on a
        repeat; its times, the library call's and the bound."""
        op = as_operator(sp.csr_matrix(mat), sparse=True, format="bsr",
                         device=dev)
        x = torch.as_tensor(np.random.RandomState(seed).randn(mat.shape[0], d)
                            .astype(np.float32), device=dev)
        out = {}
        for label, o in (("fwd", op), ("transpose", op.transpose())):
            lib, lib_name = bsr_library(o.fwd)
            ref = bsr_spmm.bsr_spmm_plain(o.fwd, x)
            check(max_rel(lib(x), ref)[1] <= 1e-5,
                  f"K3 {label}: the library call computes something else")

            def kern():
                return bsr_spmm.bsr_spmm(o.fwd, o.bwd, x)

            y = kern()
            check(torch.equal(y, kern()), f"K3 {label} d={d}: two calls "
                  f"differ")
            vs_emu = max_rel(y, bsr_spmm.bsr_spmm_split_plain(o.fwd, x))[1]
            check(vs_emu <= 2e-6, f"K3 {label} d={d} is not the split "
                  f"product: {vs_emu}")
            plan = bsr_spmm.bsr_spmm_plan(o.fwd.n_row_blocks, o.fwd.block, d)
            out[label] = compare(
                f"K3 {label} n={op.n} d={d}", [y], [ref], cuda_ms(kern),
                cuda_ms(lambda: bsr_spmm.bsr_spmm_plain(o.fwd, x)),
                device_ms=queued_ms(kern),
                library_ms=cuda_ms(lambda: lib(x)),
                library_device_ms=queued_ms(lambda: lib(x)), library=lib_name,
                repeat_equal=True, rel_err_vs_split_emulation=vs_emu,
                plan=dict(slab=plan.slab, slabs=plan.slabs,
                          **plan.panel._asdict()),
                **bsr_bound(o.fwd, d, x, ref, kind="split_tf32"))
        return dict(n=op.n, nnz_blocks=int(op.fwd.blocks.shape[0]), d=d,
                    **out)

    k3 = {"grid400_d20": k3_case(grid_lap, 20, 10),
          "rand2000_d20": k3_case(rand2k, 20, 11),
          "rand2000_d256": k3_case(rand2k, 256, 12)}

    def k4_case(mat, d, seed):
        op = as_operator(sp.csr_matrix(mat), sparse=True, format="bsr",
                         device=dev)
        rs = np.random.RandomState(seed)
        ins = [torch.as_tensor(v, device=dev) for v in (
            rs.rand(op.n, d).astype(np.float32),
            (rs.randn(d, d) / np.sqrt(d)).astype(np.float32),
            (0.1 * rs.randn(d)).astype(np.float32))]
        g = torch.as_tensor(rs.randn(op.n, d).astype(np.float32), device=dev)
        # no cotangent where the forward's bound (1e-5·max) leaves relu's
        # mask open: there a kernel and its plain version may differ
        z = bsr_spmm.bsr_spmm_plain(op.fwd, ins[0]) @ ins[1].t() + ins[2]
        open_mask = z.abs() <= 1e-5 * z.abs().max()
        check(int(open_mask.sum()) <= max(2, 1e-4 * open_mask.numel()),
              f"K4 backward d={d}: {int(open_mask.sum())} of "
              f"{open_mask.numel()} cotangents lie at relu's kink")
        g = g.masked_fill(open_mask, 0.0)
        del z, open_mask

        def fused(x, weight, b):   # w as nn.Linear hands it over: a view
            return bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, weight.t(), b)

        def plain(x, weight, b):
            return bsr_spmm.bsr_fused_rhs_plain(op.fwd, x, weight.t(), b)

        lib, lib_name = bsr_library(op.fwd)

        def library(x, weight, b):
            return torch.relu(torch.addmm(b, lib(x), weight.t()))

        ref_out = plain(*ins)
        check(max_rel(library(*ins), ref_out)[1] <= 1e-5,
              "K4: the library call computes something else")
        y = fused(*ins)
        check(torch.equal(y, fused(*ins)), f"K4 d={d}: two calls differ")
        vs_emu = max_rel(y, bsr_spmm.bsr_fused_rhs_split_plain(
            op.fwd, ins[0], ins[1].t(), ins[2]))[1]
        check(vs_emu <= 2e-6, f"K4 d={d} is not the split product: {vs_emu}")
        with torch.no_grad():
            fwd = compare(f"K4 n={op.n} d={d}", [y], [ref_out],
                          cuda_ms(lambda: fused(*ins)),
                          cuda_ms(lambda: plain(*ins)),
                          device_ms=queued_ms(lambda: fused(*ins)),
                          library_ms=cuda_ms(lambda: library(*ins)),
                          library_device_ms=queued_ms(lambda: library(*ins)),
                          library=f"relu(addmm(b, {lib_name}, w))",
                          repeat_equal=True, rel_err_vs_split_emulation=vs_emu,
                          plan=bsr_spmm.bsr_fused_plan(
                              op.fwd.n_row_blocks, op.fwd.block, d)._asdict(),
                          **bsr_bound(op.fwd, d, *ins, ref_out,
                                      dense_products=1, kind="split_tf32"))
        _, got, kernel_bwd = grads_of(fused, ins, g)
        _, ref, plain_bwd = grads_of(plain, ins, g)
        # reads Aᵀ, x, w, the saved output and g; writes dx, dw, db;
        # recomputes A·x: two BSR products and two dense ones
        bwd = compare(f"K4 backward n={op.n} d={d}", got, ref,
                      cuda_ms(kernel_bwd), cuda_ms(plain_bwd),
                      device_ms=queued_ms(kernel_bwd), library_ms=None,
                      **bsr_bound(op.bwd, d, *ins[:2], ref_out, g, *got,
                                  products=2, dense_products=2))
        return dict(n=op.n, d=d, fwd=fwd, bwd=bwd)

    k4 = {"grid400_d20": k4_case(grid_lap, 20, 13),
          "rand2000_d256": k4_case(rand2k, 256, 14),
          "rand2000_d512": k4_case(rand2k, 512, 15)}
    bsr_routes = [
        routes("bsr", as_operator(sp.csr_matrix(mat), sparse=True,
                                  format="bsr", device=dev), d, mat.shape[0],
               17)
        for mat in (grid_lap, rand2k) for d in (20, 64, 128, 256, 512)]
    print("[7] backward and BSR kernels vs plain: " + json.dumps(
        {"k1t_hub_d20": k1t, "k2_bwd_400x20": k2b, "k3": k3, "k4": k4}))
    dense_routes = [c["routes"] for c in sweep.values()]
    print("[7b] fused_profitable sweep (card: " + smi + "): " + json.dumps(
        {"dense": dense_routes, "bsr": bsr_routes,
         "ties": [f"{r['kind']} {r['n']}x{r['width']}"
                  for r in dense_routes + bsr_routes if r["tie"]]}))
    check_routes(bsr_routes)

    mark_phase("8-10")
    # ---- 8-10. training
    gx = dict(np.load(os.path.join(root, "tests", "fixtures",
                                   "ndcn_grads_grid400.npz")))
    g_tree = {name: {"w": gx[f"{name}_w"].T, "b": gx[f"{name}_b"]}
              for name in ("enc1", "enc2", "wt", "dec")}
    train_kw = dict(rtol=0.01, atol=0.001, method="dopri5")

    def rhs_vjps():
        """Count the learned RHS's evaluations and their backward calls."""
        counts = {"fwd": 0, "bwd": 0}
        base = ndcn.ode_func

        def counted(*args, **kwargs):
            out = base(*args, **kwargs)
            counts["fwd"] += 1
            if out.requires_grad:
                out.register_hook(
                    lambda g: counts.__setitem__("bwd", counts["bwd"] + 1))
            return out

        return counts, base, counted

    def train(model, op, vt, x0, target, steps, fused, max_steps):
        """``steps`` optimizer steps through ``make_sgd_step`` (torch-parity
        Adam); returns the first step's loss, gradients and RHS counts, and
        the per-step ms."""
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        first, stats_box = {}, []

        def loss_fn():
            out, stats = ndcn_forward(model, op, vt, x0, fused=fused,
                                      max_steps=max_steps, **train_kw)
            stats_box.append(stats)
            loss = l1_loss(out, target)
            return loss, loss / torch.mean(target)

        def keep_first_grads(_opt, _args, _kwargs):
            if not first:
                first["grads"] = {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}

        hook = opt.register_step_pre_hook(keep_first_grads)
        step = make_sgd_step(opt, loss_fn)
        counts, base, counted = rhs_vjps()
        ms = []
        try:
            for i in range(steps):
                ndcn.ode_func = counted if i == 0 else base
                t0 = time.perf_counter()
                loss, _ = step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    first["loss"] = float(loss)
        finally:
            ndcn.ode_func = base
            hook.remove()
        check(all(s.success for s in stats_box), "a train solve failed")
        check(np.isfinite(float(loss)), "the train loss is not finite")
        return dict(first_loss=first["loss"], first_grads=first["grads"],
                    step_ms=ms, nfe_per_step=[s.nfe for s in stats_box],
                    rhs_evals=counts["fwd"], rhs_vjps=counts["bwd"],
                    last_loss=float(loss))

    def fixture_check(res, what):
        ref = float(gx["loss_backprop"])
        loss_rel = abs(res["first_loss"] - ref) / abs(ref)
        errs = {}
        for name in ("enc1", "enc2", "wt", "dec"):
            for leaf, key in (("weight", "w"), ("bias", "b")):
                got = res["first_grads"][f"{name}.{leaf}"].cpu().numpy()
                want = gx[f"g_{name}_{key}_backprop"]
                errs[f"{name}_{key}"] = float(np.abs(got - want).sum()
                                              / np.abs(want).sum())
        check(loss_rel <= 1e-4, f"{what}: loss off the fixture: {loss_rel}")
        check(max(errs.values()) <= 1e-3, f"{what}: gradients off the "
              f"fixture: {errs}")
        return dict(loss_rel_err=loss_rel, max_grad_rel_l1=max(errs.values()))

    def summary(res):
        return {k: v for k, v in res.items() if k != "first_grads"}

    target_g = torch.as_tensor(gx["target"].T[..., None], device=dev)
    x0_g = torch.as_tensor(gx["x0"], device=dev)

    def heat_experiment(*extra):
        return run("heat", build_parser("heat").parse_args(
            ["--network", "grid", "--n", "400", "--method", "dopri5",
             "--platform", "gpu", *extra]))

    # 8. grid400 dense, fused="auto": K2 forward and backward
    kernels.reset_launch_counts()
    op_g = from_dense(grid_lap, device=dev)
    res = train(params_from_jax(g_tree, device=dev), op_g, gx["t"], x0_g,
                target_g, 6, "auto", 64)
    fix = fixture_check(res, "grid400 dense")
    drv = heat_experiment("--fused_kernel", "--niters", "20", "--test_freq",
                          "10")
    check(drv["train_losses"][-1] < drv["train_losses"][0],
          f"grid400 heat experiment: train loss did not fall "
          f"{drv['train_losses']}")
    counts = add_launches("grid400 dense training", ["fused_rhs"])
    print("[8] train grid400 dense fused=auto: " + json.dumps(
        dict(summary(res), fixture=fix, launches=counts,
             experiment={k: drv[k] for k in ("train_losses", "final",
                                             "max_steps", "total_time")})))

    # 9. grid400 BSR: fused=False (K3) and fused=True (K4)
    kernels.reset_launch_counts()
    op_gb = as_operator(sp.csr_matrix(grid_lap), sparse=True, format="bsr",
                        device=dev)
    bsr_res = {}
    for fused in (False, True):
        res = train(params_from_jax(g_tree, device=dev), op_gb, gx["t"],
                    x0_g, target_g, 6, fused, 64)
        bsr_res[f"fused_{fused}"] = dict(
            summary(res), fixture=fixture_check(res, f"grid400 bsr {fused}"))
    drv = heat_experiment("--sparse", "--sparse_format", "bsr", "--niters",
                          "10", "--test_freq", "5")
    check(drv["train_losses"][-1] < drv["train_losses"][0],
          f"grid400 BSR heat experiment: train loss did not fall "
          f"{drv['train_losses']}")
    counts = add_launches("grid400 BSR training",
                          ["bsr_spmm", "bsr_fused_rhs"])
    print("[9] train grid400 BSR: " + json.dumps(
        dict(bsr_res, launches=counts,
             experiment={k: drv[k] for k in ("train_losses", "final",
                                             "max_steps", "total_time")})))

    # 10. 200k COO: K1 forward, K1ᵀ backward
    big10 = heat_200k(op_big, splits, dev)
    x0_big, target_big, t_train, budget = (
        big10[k] for k in ("x0", "target", "t_train", "max_steps"))
    model_t = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                        device=dev)
    model_p = copy.deepcopy(model_t)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    res = train(model_t, op_big, t_train, x0_big, target_big, 5, False,
                budget)
    res10 = res                       # [25] holds its first step's NFE
    peak_train_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    counts = add_launches("200k COO training", ["coo_spmv"])
    # the first step again, with the plain versions patched in
    with plain_versions():
        out, _ = ndcn_forward(model_p, op_big, t_train, x0_big,
                              max_steps=budget, **train_kw)
        l1_loss(out, target_big).backward()
    errs = {n: rel_l1(res["first_grads"][n], p.grad)
            for n, p in model_p.named_parameters()}
    check(max(errs.values()) <= 1e-3, f"200k kernel vs plain grads: {errs}")
    print("[10] train 200k COO: " + json.dumps(
        dict(summary(res), ground_truth=dict(nfe=big10["gt_nfe"],
                                              seconds=big10["gt_seconds"]),
             max_steps=budget, peak_allocated_gb=peak_train_gb,
             launches=counts, grad_rel_l1_kernel_vs_plain=max(errs.values()))))

    mark_phase("11")
    # ---- 11. the scale path's SpMV kernels against their plain versions
    t0 = time.perf_counter()
    adj_1m = build_sparse_graph(1_000_000, 10, seed=0)   # [14] takes it too
    op_1m = from_scipy_coo(normalized_laplacian_sparse(adj_1m), device=dev)
    host_build_1m_s = time.perf_counter() - t0

    def scale_case(op, form, bf16, d=20):
        """One scale-path SpMV form, forward and over the transpose CSR,
        against its plain version and the library call; returns the
        record."""
        d_sub = coo_spmv.sublane_pad(d)
        rs = np.random.RandomState(21)
        out = dict(n=op.n, nnz=int(op.cols.shape[0]), d=d)
        for label, o in (("fwd", op), ("transpose", op.transpose())):
            a = library_csr(o, bf16)
            if form == "k1":
                x = torch.as_tensor(rs.randn(op.n, d).astype(np.float32),
                                    device=dev)

                def kern():
                    return coo_spmv.coo_spmv(o, x)

                def plain():
                    return coo_spmv.coo_spmv_plain(o.rows, o.cols, o.vals, x,
                                                   o.n, bf16)

                def library():
                    return torch.sparse.mm(
                        a, coo_spmv.round_bf16(x) if bf16 else x)
            else:
                x = torch.zeros((d_sub, op.n), device=dev)
                x[:d] = torch.as_tensor(rs.randn(d, op.n).astype(np.float32),
                                        device=dev)
                plain_fn = (coo_spmv.coo_spmv_T_wide_plain if form == "k5"
                            else coo_spmv.coo_spmv_T_plain)

                def kern():
                    return coo_spmv.spmv_T(o, x)

                def plain():
                    return plain_fn(o.rows, o.cols, o.vals, x, o.n, bf16)

                def library():   # the same function: both transposes timed
                    xr = coo_spmv.round_bf16(x) if bf16 else x
                    return torch.sparse.mm(a, xr.t()).t().contiguous()
            with gather_mode(form == "k5", bf16), torch.no_grad():
                out[label], y = spmv_record(
                    f"{form} bf16={bf16} {label} n={op.n}", o,
                    d if form == "k1" else d_sub, kern, plain, library, x)
                if form != "k1":
                    check(not y[d:].any(), f"{form} wrote the pad rows")
        return out

    def pack_case(n, bf16, d_sub=24):
        """K1-fm's pack kernel against its plain version (exact) and the
        library's transpose copy."""
        xT = torch.as_tensor(np.random.RandomState(22).randn(d_sub, n)
                             .astype(np.float32), device=dev)
        table = coo_spmv.pack_rows(xT, bf16)
        ref = coo_spmv.pack_rows_plain(xT, bf16)
        torch.cuda.synchronize()
        check(torch.equal(table, ref), f"the pack kernel is off at n={n}")

        def library():
            t = xT.t()
            return (t.to(torch.bfloat16) if bf16 else t).contiguous()

        return dict(n=n, d_sub=d_sub, max_abs_err=0.0, repeat_equal=True,
                    ms=cuda_ms(lambda: coo_spmv.pack_rows(xT, bf16)),
                    device_ms=queued_ms(lambda: coo_spmv.pack_rows(xT, bf16)),
                    library_device_ms=queued_ms(library),
                    plain_ms=cuda_ms(lambda: coo_spmv.pack_rows_plain(xT,
                                                                      bf16)),
                    library_ms=cuda_ms(library),
                    **bound(nbytes(xT, table), 0))

    k11 = {}
    k11["k1_f32_1m"] = scale_case(op_1m, "k1", False)
    for bf16 in (False, True):
        kind = "bf16" if bf16 else "f32"
        k11[f"k1fm_{kind}_hub"] = scale_case(op_hub, "k1fm", bf16)
        k11[f"k5_{kind}_hub"] = scale_case(op_hub, "k5", bf16)
        k11[f"pack_{kind}_1m"] = pack_case(op_1m.n, bf16)
    k11["pack_f32_200k"] = pack_case(op_big.n, False)
    for size, op in (("200k", op_big), ("1m", op_1m)):
        k11[f"k1_bf16_{size}"] = scale_case(op, "k1", True)
        for form in ("k1fm", "k5"):
            for bf16 in (False, True):
                k11[f"{form}_{'bf16' if bf16 else 'f32'}_{size}"] = \
                    scale_case(op, form, bf16)
    print(f"[11] scale SpMV kernels vs plain (1M host build "
          f"{host_build_1m_s:.3f} s): " + json.dumps(k11))
    del op_1m
    csr_tensors.clear()
    torch.cuda.empty_cache()

    mark_phase("12")
    # ---- 12. the scale experiment at 1M nodes (and 200k, bf16 and wide)
    def scale_args(*argv):
        return large_graph.build_parser().parse_args(list(argv))

    def scale_run(what, needed, *argv):
        kernels.reset_launch_counts()
        rec = large_graph.run(scale_args(*argv))
        counts = add_launches(what, needed)
        torch.cuda.empty_cache()
        return rec, counts

    # each run below would build its graph again and the 1M ones solve the
    # same ground truth again: the problems are built once a shape for the
    # phase and the 1M truth is cached (the driver's --gt_cache)
    problems12 = {}
    build_problem12 = large_graph.build_problem

    def cached_problem(args, device):
        key = (args.n, args.deg, args.seed, args.fmt, args.dynamics, args.T,
               args.time_tick, str(device))
        if key not in problems12:
            problems12[key] = build_problem12(args, device)
        return problems12[key]

    large_graph.build_problem = cached_problem
    gt_1m = os.path.join(root, "build", "smoke_gt_1m_heat.npz")
    if os.path.exists(gt_1m):
        os.remove(gt_1m)

    def scale_summary(rec, counts):
        keep = ("train_steps_per_sec", "rel_loss_initial", "rel_loss_final",
                "max_steps", "attempts_taken", "elastic_rollbacks",
                "hbm_peak_gb",
                "hbm_peak_source", "roofline", "layout", "solve_layout",
                "train_losses", "ground_truth_s", "node_evals_per_sec")
        return dict({k: rec[k] for k in keep}, launches=counts)

    # the 200k runs first and the 1M ones after, the cache cleared between:
    # one problem of the phase on the card at a time, so each run's
    # hbm_peak_gb holds only its own problem's arrays (the 1M problem stays
    # on for [p] as `prob`)
    rec_k1bf, c_k1bf = scale_run("200k scale experiment, kernel bf16",
                                 ["coo_spmv_bf16"], "--n", "200000",
                                 "--iters", "3", "--kernel_precision", "bf16")
    check(rec_k1bf["solve_layout"] == "nd", "200k auto should stay nd")
    with gather_mode(True, False):
        rec_wide, c_wide = scale_run("200k scale experiment, wide gather",
                                     ["coo_spmv_T_wide"], "--n", "200000",
                                     "--iters", "3", "--layout",
                                     "feature_major")
    problems12.clear()
    torch.cuda.empty_cache()

    est = large_graph.run(scale_args("--n", "1000000", "--estimate"))
    est_bf = large_graph.run(scale_args(
        "--n", "1000000", "--estimate", "--emission_precision", "bf16",
        "--residual_precision", "bf16"))
    rec_1m, c_1m = scale_run("1M scale experiment",
                             ["coo_spmv", "coo_spmv_T", "coo_spmv_T_pack"],
                             "--n", "1000000", "--iters", "60", "--roofline",
                             "--hbm_probe", "--gt_cache", gt_1m)
    check(rec_1m["layout"] == "auto"
          and rec_1m["solve_layout"] == "feature_major",
          f"1M: layout auto resolved to {rec_1m['solve_layout']}")
    check(rec_1m["train_losses"][-1] < rec_1m["train_losses"][0],
          f"1M: the train loss did not fall {rec_1m['train_losses']}")
    rec_bf, c_bf = scale_run("1M scale experiment, bf16 levers",
                             ["coo_spmv_T", "coo_spmv_T_pack"],
                             "--n", "1000000", "--iters", "10", "--hbm_probe",
                             "--gt_cache", gt_1m,
                             "--emission_precision", "bf16",
                             "--residual_precision", "bf16")
    check(rec_bf["train_losses"][-1] < rec_bf["train_losses"][0],
          f"1M bf16 levers: the train loss did not fall "
          f"{rec_bf['train_losses']}")

    # the first train step again, kernels against plain versions
    args_1m = scale_args("--n", "1000000", "--gt_cache", gt_1m)
    prob = large_graph.build_problem(args_1m, dev)
    truth_1m, _, _ = large_graph.ground_truth(args_1m, prob)
    target_1m = truth_1m[torch.as_tensor(prob.splits.id_train, device=dev)]
    del truth_1m
    model_1m = large_graph.new_model(args_1m, dev)
    budget_1m, _ = large_graph.probe_budget(args_1m, prob, model_1m)
    grads, first_step_peak_gb = {}, {}
    for which in ("kernel", "plain"):
        m_ = copy.deepcopy(model_1m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident_gb = torch.cuda.memory_allocated(dev) / 1e9
        with plain_versions(which == "plain"):
            loss, _ = large_graph.train_objective(args_1m, prob, m_,
                                                  target_1m, budget_1m)()
            loss.backward()
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        first_step_peak_gb[which] = dict(peak=peak_gb, resident=resident_gb,
                                         step=peak_gb - resident_gb)
        grads[which] = {n: p.grad for n, p in m_.named_parameters()}
    errs_1m = {n: rel_l1(grads["kernel"][n], grads["plain"][n])
               for n in grads["kernel"]}
    check(max(errs_1m.values()) <= 1e-3, f"1M kernel vs plain grads: "
          f"{errs_1m}")
    del grads
    torch.cuda.empty_cache()

    # the three solves of the 1M step side by side: 'auto' (feature-major,
    # K1-fm) above, feature-major under GATHER_WIDE (K5), the (n, d) layout
    with gather_mode(True, False):
        rec_1m_wide, c_1m_wide = scale_run(
            "1M scale experiment, wide gather", ["coo_spmv_T_wide"], "--n",
            "1000000", "--iters", "10", "--hbm_probe", "--gt_cache", gt_1m)
    rec_1m_nd, c_1m_nd = scale_run(
        "1M scale experiment, (n, d) layout", ["coo_spmv"], "--n", "1000000",
        "--iters", "10", "--hbm_probe", "--layout", "nd", "--gt_cache", gt_1m)
    large_graph.build_problem = build_problem12
    problems12.clear()
    os.remove(gt_1m)
    check(rec_1m_wide["solve_layout"] == "feature_major"
          and rec_1m_nd["solve_layout"] == "nd", "1M layouts resolved wrong")
    print("[12] scale experiment: " + json.dumps({
        "1m": scale_summary(rec_1m, c_1m),
        # the JAX package's record of the same 60 iterations (a TPU run:
        # information, not a target)
        "1m_rel_loss_final_beside_jax_record": {
            "port": rec_1m["rel_loss_final"],
            "results/scale_1m_heat.json": 0.0562},
        "1m_fm_wide": scale_summary(rec_1m_wide, c_1m_wide),
        "1m_nd": scale_summary(rec_1m_nd, c_1m_nd),
        "1m_estimate": est, "1m_bf16_levers": scale_summary(rec_bf, c_bf),
        "1m_bf16_levers_estimate": est_bf,
        "1m_first_step_grad_rel_l1_kernel_vs_plain": max(errs_1m.values()),
        "1m_first_step_peak_allocated_gb": first_step_peak_gb,
        "200k_kernel_bf16": scale_summary(rec_k1bf, c_k1bf),
        "200k_fm_wide": scale_summary(rec_wide, c_wide)}))

    mark_phase("13")
    # ---- 13. the microbenchmarks at their defaults
    from ndcn_tpu_torch.tools import (bench_wide_gather, microbench_sparse,
                                      probe_inkernel_gather)
    kernels.reset_launch_counts()
    mb = microbench_sparse.main([])
    probe = probe_inkernel_gather.main([])
    wide_tab = bench_wide_gather.main([])
    c_tools = add_launches("the microbenchmarks",
                           ["sliced_tile_reduce", "row_gather", "coo_spmv_T",
                            "coo_spmv_T_wide"])
    torch.cuda.empty_cache()
    check(mb["sliced_spmv_kernel_err"] <= 1e-5
          and mb["sliced_reduce_kernel_vs_plain"] <= 1e-5
          and mb["take_segsum_err"] <= 1e-5 and mb["inkernel_take"],
          f"microbench_sparse checks: {mb}")
    check(all(isinstance(probe[f], float) for f in
              ("kernel", "index", "index_select", "take_along_dim")),
          f"probe_inkernel_gather: {probe}")
    for row in wide_tab["modes"]:
        check(row["rel_err"] <= (2e-2 if row["precision"] == "bf16"
                                 else 1e-5), f"bench_wide_gather: {row}")
    print("[13] microbenchmarks: " + json.dumps(
        {"microbench_sparse": mb, "probe_inkernel_gather": probe,
         "bench_wide_gather": wide_tab, "launches": c_tools}))

    mark_phase("14")
    # ---- 14. K1-w and the mutualistic and gene dynamics
    def k1w_case(a, d, seed):
        """K1-w forward and backward on the adjacency ``a`` at width d
        against the plain version, which is also the library yardstick."""
        op = from_scipy_coo(a, device=dev)
        rs = np.random.RandomState(seed)
        x = torch.as_tensor((rs.rand(op.n, d) * 3 + 0.2).astype(np.float32),
                            device=dev)
        g = torch.as_tensor(rs.randn(op.n, d).astype(np.float32), device=dev)
        coef = (5.0, 0.1, 0.9)     # d, e, h after the reference's swap
        nnz = int(op.cols.shape[0])
        out = dict(n=op.n, nnz=nnz, d=d,
                   split_rows=int(op.split.long_rows.shape[0]),
                   split_rows_t=int(op.split_t.long_rows.shape[0]))
        # per edge and feature: the denominator, the pair term and its sum
        # (8 operations); each side of the backward 12
        for label, kern, plain, n_bytes, flops in (
                ("fwd", lambda: coo_mutual.mutual_forward(op, x, *coef),
                 lambda: coo_mutual.mutual_forward_plain(op, x, *coef),
                 nbytes(op.row_ptr, op.cols, op.vals, x, x), 8 * nnz * d),
                ("bwd", lambda: coo_mutual.mutual_backward(op, x, g, *coef),
                 lambda: coo_mutual.mutual_backward_plain(op, x, g, *coef),
                 nbytes(op.row_ptr, op.cols, op.vals, op.row_ptr_t,
                        op.cols_t, op.vals_t, x, g, x), 24 * nnz * d)):
            edge_before = coo_mutual.EDGE_LAUNCHES
            y, ref = kern(), plain()
            torch.cuda.synchronize()
            # the form that ran, from the edge form's own launch count
            form = ("edges" if coo_mutual.EDGE_LAUNCHES
                    == edge_before + (1 if label == "fwd" else 2) else "rows")
            err, rel = max_rel(y, ref)
            check(rel <= 1e-5, f"K1-w {label} n={op.n} d={d} disagrees with "
                  f"its plain version: {rel}")
            check(torch.equal(y, kern()), f"K1-w {label}: two calls differ")
            plain_ms = cuda_ms(plain, iters=15)
            out[label] = dict(
                form=form, max_abs_err=err, rel_err=rel, repeat_equal=True,
                ms=cuda_ms(kern, iters=15), device_ms=queued_ms(kern),
                plain_ms=plain_ms, library_ms=plain_ms,
                library_device_ms=queued_ms(plain),
                library="the plain version (gather, weight, index_add_)",
                **bound(n_bytes, flops))
        return out

    hub_abs = abs(hub)
    k1w = {"50k_d1": k1w_case(build_sparse_graph(50_000, 10, seed=0), 1, 31),
           "200k_d1": k1w_case(adj, 1, 32),
           "200k_d2": k1w_case(adj, 2, 35),
           "hub_d1": k1w_case(hub_abs, 1, 38),
           "hub_d20": k1w_case(hub_abs, 20, 33),
           "hub_transposed_d20": k1w_case(hub_abs.T.tocsr(), 20, 34),
           "1m_d1": k1w_case(adj_1m, 1, 36)}
    crossover = coo_mutual.EDGE_MAX_WIDTH
    if f"200k_d{crossover}" not in k1w:
        k1w[f"200k_d{crossover}"] = k1w_case(adj, crossover, 37)
    del adj_1m
    check(k1w["hub_d20"]["split_rows"] > 0, "the hub graph has no split row")
    wrong_form = {f"{k} {label}": c[label]["form"] for k, c in k1w.items()
                  for label in ("fwd", "bwd")
                  if (c[label]["form"] == "edges") != (c["d"] <= crossover)}
    check(not wrong_form, f"K1-w ran the wrong form (the edge form to "
          f"d = {crossover}, the warp form above): {wrong_form}")

    # the physics on the card against the CPU: a 5,000-node graph
    a5k = build_sparse_graph(5_000, 10, seed=0)
    x0_5k = np.random.RandomState(0).uniform(0.0, 25.0, (5_000, 1)) \
        .astype(np.float32)
    t_5k = sample_times(5.0, 40, "irregular", seed=0).t
    gt5k = {}
    for where in ("gpu", "cpu"):
        d_ = dev if where == "gpu" else torch.device("cpu")
        sol, st = ground_truth("mutualistic", from_scipy_coo(a5k, device=d_),
                               torch.as_tensor(x0_5k, device=d_), t_5k,
                               rtol=1e-6, atol=1e-8)
        check(st.success, f"5k mutualistic ground truth on the {where}: {st}")
        gt5k[where] = (sol.cpu(), st.nfe)
    gt5k_rel = rel_l1(gt5k["gpu"][0], gt5k["cpu"][0])
    # the step counts may part by an attempt or two: at rtol 1e-6 an
    # attempt near the accept boundary is decided by fp32 sums taken in
    # another order (650 evaluations on the card against 644 on the CPU:
    # one more rejected attempt; the CPU alone gives 650 with the sum
    # reversed or taken in float64, tests/test_torch_dynamics.py::
    # test_ground_truth_step_count_follows_the_sum_order)
    nfe_gap = abs(gt5k["gpu"][1] - gt5k["cpu"][1]) / gt5k["cpu"][1]
    check(gt5k_rel <= 1e-4 and nfe_gap <= 0.02,
          f"5k mutualistic ground truth, card vs CPU: {gt5k_rel}, NFE "
          f"{gt5k['gpu'][1]} vs {gt5k['cpu'][1]}")

    def falls(losses, what):
        check(losses[-1] < losses[0],
              f"{what}: the train loss did not fall {losses}")

    rec_mut, c_mut = scale_run("50k mutualistic scale experiment",
                               ["coo_mutual", "coo_mutual_edges",
                                "coo_spmv"], "--n", "50000",
                               "--dynamics", "mutualistic", "--iters", "60")
    falls(rec_mut["train_losses"], "50k mutualistic")
    rec_gene, c_gene = scale_run("50k gene scale experiment", ["coo_spmv"],
                                 "--n", "50000", "--dynamics", "gene",
                                 "--iters", "10")
    falls(rec_gene["train_losses"], "50k gene")
    drivers = {}
    for kind, extra, needed in (
            ("mutualistic", [], []),
            ("gene", ["--method", "dopri5", "--sparse"], []),
            ("mutualistic", ["--method", "dopri5", "--sparse",
                             "--sparse_format", "coo"], ["coo_spmv"])):
        what = " ".join([kind, *extra]) or kind
        kernels.reset_launch_counts()
        drv = run(kind, build_parser(kind).parse_args(
            ["--niters", "20", "--test_freq", "10", *extra]))
        counts = add_launches(f"the {what} experiment", needed)
        falls(drv["train_losses"], f"the {what} experiment")
        drivers[what] = dict({k: drv[k] for k in (
            "train_losses", "final", "max_steps", "total_time")},
            launches=counts)
    print("[14] K1-w and the mutualistic / gene dynamics (card: " + smi
          + "): " + json.dumps({
              "k1w": k1w, "5k_ground_truth_rel_l1_card_vs_cpu": gt5k_rel,
              "5k_ground_truth_nfe_card_cpu": [gt5k["gpu"][1],
                                               gt5k["cpu"][1]],
              "50k_mutualistic": dict(
                  scale_summary(rec_mut, c_mut),
                  coo_mutual_launches_per_ground_truth=c_mut["coo_mutual"],
                  # the JAX package's record of this argv (a TPU run:
                  # information, not a target)
                  rel_loss_final_of_results_scale_50k_mutualistic=0.0511),
              "50k_gene": scale_summary(rec_gene, c_gene),
              "drivers": drivers}))
    del hub_abs
    torch.cuda.empty_cache()

    mark_phase("15")
    # ---- 15. the continuous adjoint, the other solvers, checkpoint / resume
    t15 = time.perf_counter()
    gx_t = torch.as_tensor(gx["target"].T[..., None], device=dev)

    def adjoint_step(op, fused, adjoint):
        """One grid400 train step at the fixture's weights: its loss,
        gradients, forward and backward NFE, ms and peak memory."""
        model = params_from_jax(g_tree, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out, stats = ndcn_forward(model, op, gx["t"], x0_g, fused=fused,
                                  adjoint=adjoint, max_steps=64, **train_kw)
        loss = (out - gx_t).abs().mean()
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(stats.success, f"grid400 adjoint={adjoint} solve failed")
        back = stats.backward if adjoint else []
        check(all(s.success for s in back), "an adjoint interval failed")
        return dict(loss=float(loss.detach()), ms=ms, nfe_forward=stats.nfe,
                    nfe_backward=sum(s.nfe for s in back) if adjoint
                    else None,
                    # the step's own peak, above what was allocated when
                    # it started (the earlier phases' operators and models)
                    step_peak_mb=(torch.cuda.max_memory_allocated(dev)
                                  - base) / 1e6,
                    grads={n: p.grad.cpu() for n, p in
                           model.named_parameters()})

    adj = {}
    for route, op, fused, needed in (
            ("dense_auto", op_g, "auto", ["fused_rhs"]),
            ("coo", as_operator(sp.csr_matrix(grid_lap), sparse=True,
                                format="coo", device=dev), False,
             ["coo_spmv"]),
            ("bsr_fused", op_gb, True, ["bsr_fused_rhs", "bsr_spmm"])):
        adjoint_step(op, fused, True)              # warm
        kernels.reset_launch_counts()
        res = adjoint_step(op, fused, True)
        counts = add_launches(f"grid400 {route} adjoint step", needed)
        bp = adjoint_step(op, fused, False)
        ref = float(gx["loss_adjoint"])
        loss_rel = abs(res["loss"] - ref) / abs(ref)
        errs = {}
        for name in ("enc1", "enc2", "wt", "dec"):
            for leaf, key in (("weight", "w"), ("bias", "b")):
                got = res["grads"][f"{name}.{leaf}"]
                check(bool(torch.isfinite(got).all()),
                      f"{route} adjoint: a non-finite gradient in {name}")
                want = torch.as_tensor(gx[f"g_{name}_{key}_adjoint"])
                errs[f"{name}_{key}"] = float((got - want).abs().sum()
                                              / want.abs().sum())
        check(loss_rel <= 1e-4, f"{route} adjoint loss off the fixture: "
              f"{loss_rel}")
        check(max(errs.values()) <= 1e-3, f"{route} adjoint gradients off "
              f"the fixture: {errs}")
        adj[route] = dict(
            {k: v for k, v in res.items() if k != "grads"},
            loss_rel_err=loss_rel, max_grad_rel_l1=max(errs.values()),
            launches={k: v for k, v in counts.items() if v},
            backprop={k: v for k, v in bp.items() if k != "grads"})

    # (b) serve grid400 dense with the other methods, card against CPU:
    # the CPU's answers are the committed references
    # (tools/smoke_references.py, tests/fixtures/smoke_cpu_references.npz)
    methods = {}
    refs = smoke_references.load()
    for method in smoke_references.SERVE_METHODS:
        kw = dict(serve_kw, method=method)
        kernels.reset_launch_counts()
        srv = make_server(model_grid, op_grid, fx["t"], **kw)
        answers, first = serve_all(srv, requests_grid, f"grid400 {method}")
        counts = add_launches(f"grid400 {method} serving", ["fused_rhs"])
        out_cpu = torch.as_tensor(refs[f"serve/{method}/out"])
        ok_cpu = bool(refs[f"serve/{method}/ok"])
        err = rel_l1(first.cpu(), out_cpu)
        nfe_gpu, nfe_cpu = answers[0]["nfe"], int(refs[f"serve/{method}/nfe"])
        # the same solve in float64 on the CPU: how far float32 rounding
        # alone moves this method's answer (explicit_adams at order 11 is
        # near its stability limit on this problem and amplifies it); the
        # card is held to 1e-4 of the CPU or to twice that distance
        f32_gap = float(refs[f"serve/{method}/f32_vs_f64"])
        bar = max(1e-4, 2 * f32_gap)
        check(ok_cpu and err <= bar, f"grid400 {method}: card vs CPU "
              f"{err} (bar {bar})")
        check(abs(nfe_gpu - nfe_cpu) <= 0.02 * nfe_cpu,
              f"grid400 {method}: NFE {nfe_gpu} on the card, {nfe_cpu} on "
              f"the CPU")
        methods[method] = dict(rel_l1_gpu_vs_cpu=err, bar=bar,
                               rel_l1_cpu_f32_vs_f64=f32_gap,
                               nfe_gpu=nfe_gpu,
                               nfe_cpu=nfe_cpu, requests=answers,
                               fused_rhs_launches=counts["fused_rhs"])

    # (c) the heat driver under --adjoint and --method adams, and a run cut
    # at a checkpoint and resumed against the uninterrupted one
    drv15 = {}
    for label, extra in (("adjoint_dopri5", ["--adjoint"]),
                         ("adams", ["--method", "adams"])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = heat_experiment(*extra, "--niters", "10", "--test_freq", "5")
        counts = add_launches(f"the heat driver {label}", [])
        falls(out["train_losses"], f"the heat driver {label}")
        drv15[label] = dict(train_losses=out["train_losses"],
                            final=out["final"], seconds=time.perf_counter()
                            - t0, max_steps=out["max_steps"])
    ckpt_dir = os.path.join(root, "build", "smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    ckpt_args = ("--test_freq", "5", "--ckpt_dir", ckpt_dir, "--ckpt_freq",
                 "5")
    full = heat_experiment("--niters", "10", "--test_freq", "5")
    half = heat_experiment("--niters", "5", *ckpt_args)
    rest = heat_experiment("--niters", "10", *ckpt_args)
    add_launches("the checkpointed heat driver", [])
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = half["train_losses"] + rest["train_losses"]
    check(resumed == full["train_losses"] and rest["final"] == full["final"],
          f"a resumed run parts from the uninterrupted one: {resumed} vs "
          f"{full['train_losses']}")
    drv15["resume"] = dict(uninterrupted=full["train_losses"],
                           resumed=resumed, bit_equal=True)
    print("[15] adjoint, solvers, checkpoint (card: " + smi + "): "
          + json.dumps({"adjoint_grid400": adj, "serve_grid400": methods,
                        "drivers": drv15,
                        "seconds": time.perf_counter() - t15}))

    mark_phase("16")
    # ---- 16. the classification tasks: K1 and K3 at the citation widths,
    # the card's train step against the CPU's, the showcase, the GCN zoo
    t16 = time.perf_counter()
    from ndcn_tpu_torch.data import load_planetoid
    from ndcn_tpu_torch.experiments import dgnn
    from ndcn_tpu_torch.models.gcn_zoo import ZOO
    from ndcn_tpu_torch.train.losses import cross_entropy

    cora = load_planetoid("cora", alpha=0.5, data_dir=os.path.join(root,
                                                                   "data"))
    citeseer = load_planetoid("citeseer", alpha=0.5,
                              data_dir=os.path.join(root, "data"))

    # (a) K1 and K1ᵀ on both graphs, K3 and K3ᵀ on cora's BSR operator
    def k1_both(mat, d, seed):
        """K1 and K1ᵀ (over the transpose CSR) at width d: [3] / [7]'s
        bars, bit-equal repeats, times, the bound, ``torch.sparse.mm``."""
        op = from_scipy_coo(mat, device=dev)
        out = dict(n=op.n, nnz=int(op.cols.shape[0]), d=d,
                   max_row_degree=int(np.diff(mat.indptr).max()),
                   split_rows=int(op.split.long_rows.shape[0]))
        x = torch.as_tensor(np.random.RandomState(seed).randn(op.n, d)
                            .astype(np.float32), device=dev)
        for label, o in (("fwd", op), ("transpose", op.transpose())):
            a = library_csr(o)
            out[label], _ = spmv_record(
                f"K1 {label} n={o.n} d={d}", o, d,
                lambda: coo_spmv.coo_spmv(o, x),
                lambda: coo_spmv.coo_spmv_plain(o.rows, o.cols, o.vals, x,
                                                o.n),
                lambda: torch.sparse.mm(a, x), x)
        return out

    k1_cite = {f"cora_d{d}": k1_both(cora.operator, d, 40 + d)
               for d in (7, 16, 1433)}
    k1_cite.update({f"citeseer_d{d}": k1_both(citeseer.operator, d, 50 + d)
                    for d in (6, 16, 3703)})

    # K1's wide form at the raw features' widths: the form that ran, the
    # narrow form's time on the same inputs (bit-equal) and with the long
    # rows cut at 16 edges (where the narrow form's time went: the longest
    # row's chain of segments), bf16, and 2 row blocks
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    def wide_rowblocks(op, x, p=2):
        """K1 on p row blocks of ``op`` (A's and Aᵀ's) against the table:
        concatenated bit-equal to the whole launch, within 1e-5 of the
        plain version; the blocks' device ms, library calls (on each
        block's CSR) and bounds summed, beside the whole launch's."""
        blocks = [shard_coo_at(op, p, r, None) for r in range(p)]
        table = torch.cat([x, x.new_zeros((blocks[0].n_pad - op.n,
                                           x.shape[1]))])
        out = {}
        for label, whole in (("fwd", op), ("transpose", op.transpose())):
            parts = [b.block_t if label == "transpose" else b.block
                     for b in blocks]
            y = torch.cat([coo_spmv._apply(bl, table)[:b.stop - b.start]
                           for bl, b in zip(parts, blocks)])
            ref = coo_spmv.coo_spmv_plain(whole.rows, whole.cols, whole.vals,
                                          x, whole.n)
            check(torch.equal(y, coo_spmv._apply(whole, x)),
                  f"K1 on {p} row blocks {label}: the blocks part from the "
                  f"whole launch")
            err, rel = max_rel(y, ref)
            check(rel <= 1e-5, f"K1 on {p} row blocks {label}: {rel}")
            rec = dict(max_abs_err=err, rel_err=rel, concat_equal_whole=True,
                       whole_device_ms=queued_ms(
                           lambda w=whole: coo_spmv._apply(w, x)),
                       device_ms=0.0, library_device_ms=0.0, bound_ms=0.0)
            for bl in parts:
                a = torch.sparse_csr_tensor(bl.row_ptr, bl.cols, bl.vals,
                                            size=(bl.n, bl.n_table))
                rec["device_ms"] += queued_ms(
                    lambda bl=bl: coo_spmv._apply(bl, table))
                rec["library_device_ms"] += queued_ms(
                    lambda a=a: torch.sparse.mm(a, table))
                rec["bound_ms"] += bound(
                    nbytes(bl.row_ptr, bl.cols, bl.vals, table, x[:bl.n]),
                    2 * int(bl.cols.shape[0]) * x.shape[1])["bound_ms"]
            out[label] = rec
        return out

    for label, mat, d in (("cora_d1433", cora.operator, 1433),
                          ("citeseer_d3703", citeseer.operator, 3703)):
        op = from_scipy_coo(mat, device=dev)
        x = torch.as_tensor(np.random.RandomState(d).randn(op.n, d)
                            .astype(np.float32), device=dev)
        case = k1_cite[label]
        for part, o in (("fwd", op), ("transpose", op.transpose())):
            kernels.reset_launch_counts()
            y = coo_spmv.coo_spmv(o, x)
            case[part]["form"] = ("wide" if kernels.launch_counts()[
                "coo_spmv_wide"] else "narrow")
            check(case[part]["form"] == "wide",
                  f"K1 {label} {part} did not take the wide form")
            check(torch.equal(y, coo_spmv.coo_spmv_narrow(o, x)),
                  f"K1 {label} {part}: the wide form parts from the narrow")
            cut = o._replace(split=coo_spmv.split_rows(
                o.row_ptr.cpu().numpy(), 16, device=dev))
            narrow = coo_spmv.coo_spmv_narrow
            case[part].update(
                narrow_equal=True,
                narrow_device_ms=queued_ms(lambda o=o: narrow(o, x)),
                narrow_cut16_device_ms=queued_ms(lambda: narrow(cut, x)))
        case["bf16"] = scale_case(op, "k1", True, d)
        case["row_blocks_2"] = wide_rowblocks(op, x)
        del x
    torch.cuda.empty_cache()
    k3_cite = {f"cora_d{d}": k3_case(cora.operator, d, 60 + d)
               for d in (7, 16, 1433)}
    torch.cuda.empty_cache()

    # (b) one cora differential_gcn step on the card against the same step
    # on the CPU (the committed reference, tools/smoke_references.py)
    refs16 = smoke_references.load()
    steps16 = {}
    for fmt, needed in (("dense", []), ("coo", ["coo_spmv"]),
                        ("bsr", ["bsr_spmm"])):
        smoke_references.cora_step(dev, fmt, cora)           # warm
        kernels.reset_launch_counts()
        gpu = smoke_references.cora_step(dev, fmt, cora)
        counts = add_launches(f"the cora {fmt} step", needed)
        cpu_loss = float(refs16[f"cora/{fmt}/loss"])
        cpu_nfe = int(refs16[f"cora/{fmt}/nfe"])
        grad_err = max(rel_l1(gpu["grads"][k], v) for k, v in
                       smoke_references.step_grads(refs16,
                                                   f"cora/{fmt}").items())
        loss_err = abs(gpu["loss"] - cpu_loss) / abs(cpu_loss)
        check(loss_err <= 1e-4 and grad_err <= 1e-3 and gpu["nfe"] == cpu_nfe,
              f"cora {fmt} step, card vs CPU: loss {loss_err}, gradients "
              f"{grad_err}, NFE {gpu['nfe']} vs {cpu_nfe}")
        steps16[fmt] = dict(loss_rel_err=loss_err, max_grad_rel_l1=grad_err,
                            nfe=gpu["nfe"], ms=gpu["ms"],
                            launches={k: v for k, v in counts.items() if v})

    # (c) the showcase: the recipe of results/showcase_cora_100.json
    # (README.md:64) through the driver, in process
    recipe = ["--model", "differential_gcn", "--iter", "1", "--dropout", "0",
              "--hidden", "256", "--T", "1.2", "--time_tick", "16",
              "--epochs", "100", "--weight_decay", "0.024", "--no_control",
              "--method", "dopri5", "--alpha", "0", "--fastmode",
              "--data_dir", os.path.join(root, "data")]

    def driver(what, needed, *argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = dgnn.run(dgnn.build_parser().parse_args(list(argv)))
        torch.cuda.synchronize()
        counts = add_launches(what, needed)
        check(np.isfinite(out["rows"][-1][1]), f"{what}: test loss "
              f"{out['rows'][-1][1]}")
        return dict(test_acc=out["rows"][-1][2], test_loss=out["rows"][-1][1],
                    seconds=time.perf_counter() - t0,
                    first_loss=out["train_losses"][0],
                    last_loss=out["train_losses"][-1],
                    max_steps=out.get("max_steps"),
                    launches={k: v for k, v in counts.items() if v}), out

    # the driver on its own defaults (hidden 16, dropout 0.5, T 2, 200
    # epochs): not the showcase's recipe, so no accuracy bar
    rec, out = driver("the cora driver on its defaults", [], "--dataset",
                      "cora", "--model", "differential_gcn", "--seed", "0",
                      "--data_dir", os.path.join(root, "data"))
    show = {"cora_defaults_seed0": rec}
    falls(out["train_losses"], "the cora driver on its defaults")
    for seed in (0, 1, 2):
        show[f"cora_dense_seed{seed}"], _ = driver(
            f"the cora showcase, seed {seed}", [], "--dataset", "cora",
            *recipe, "--seed", str(seed))
    accs = [show[f"cora_dense_seed{s}"]["test_acc"] for s in (0, 1, 2)]
    mean_acc = float(np.mean(accs))
    # results/showcase_cora_100.json: mean 0.8317, std 0.0098 over 100
    # models (a TPU run: the bar is its mean ± 3 standard errors of 3)
    band = (0.8317 - 3 * 0.0098 / np.sqrt(3), 0.8317 + 3 * 0.0098 / np.sqrt(3))
    check(band[0] <= mean_acc <= band[1], f"cora showcase mean accuracy "
          f"{mean_acc} ({accs}) outside {band}")
    for label, extra, needed in (("cora_coo_seed0", ["--sparse"],
                                  ["coo_spmv"]),
                                 ("cora_bsr_seed0", ["--sparse",
                                                     "--sparse_format",
                                                     "bsr"], ["bsr_spmm"])):
        show[label], out = driver(f"the cora showcase {label}", needed,
                                  "--dataset", "cora", *recipe, "--seed",
                                  "0", *extra)
        falls(out["train_losses"], f"the cora showcase {label}")
    show["citeseer_dense_seed0"], _ = driver(
        "the citeseer showcase", [], "--dataset", "citeseer", *recipe,
        "--seed", "0")
    cite_band = (0.7065 - 3 * 0.0061, 0.7065 + 3 * 0.0061)
    check(cite_band[0] <= show["citeseer_dense_seed0"]["test_acc"]
          <= cite_band[1], f"citeseer showcase accuracy "
          f"{show['citeseer_dense_seed0']['test_acc']} outside {cite_band}")

    # (d) the GCN zoo through the driver on cora with --sparse (K1 at 7,
    # 16 and 1433 inside training); DeepGCN3 dense, 50 epochs
    zoo = {}
    base = ["--dataset", "cora", "--seed", "0", "--data_dir",
            os.path.join(root, "data")]
    for name in ZOO:
        extra = (["--epochs", "50", "-nhl", "2"] if name == "DeepGCN3" else
                 ["--sparse", "--epochs", "100"]
                 + ([] if name in ("GCN", "DeepGCN2") else ["-nhl", "2"])
                 + (["--Euler"] if name == "resGCN" else []))
        zoo[name], out = driver(
            f"the {name} driver", [] if name == "DeepGCN3" else ["coo_spmv"],
            "--model", name, *base, *extra)
        falls(out["train_losses"], f"the {name} driver")
    zoo["GCN"]["cpu_test_acc"] = float(refs16["gcn_driver/test_acc"])
    check(abs(zoo["GCN"]["test_acc"] - zoo["GCN"]["cpu_test_acc"]) <= 0.02,
          f"GCN on the card {zoo['GCN']['test_acc']} against the CPU "
          f"{zoo['GCN']['cpu_test_acc']}")
    print("[16] classification (card: " + smi + "): " + json.dumps({
        "k1_citation": k1_cite, "k3_cora": k3_cite,
        "cora_step_card_vs_cpu": steps16, "showcase": show,
        "cora_mean_acc_seeds_0_2": mean_acc, "cora_band": band,
        "citeseer_band": cite_band, "zoo": zoo,
        "seconds": time.perf_counter() - t16}))
    torch.cuda.empty_cache()

    mark_phase("17")
    # ---- 17. the temporal-GNN baselines, report/, the Lotka-Volterra demo
    # and the T x alpha sweep
    t17 = time.perf_counter()
    from ndcn_tpu_torch.experiments import lv, summarize, sweep_t_alpha
    from ndcn_tpu_torch.graph.operators import laplacian_dense, zipf_smoothing
    from ndcn_tpu_torch.models import init_temporal_gcn, temporal_gcn_forward
    from ndcn_tpu_torch.report import results as results_lib

    # (a) K1 / K1ᵀ and K3 / K3ᵀ at d = 5 on the grid400 Kipf operator
    adj400 = build_network("grid", 400)
    kipf400 = zipf_smoothing(adj400)
    k1_temporal = {"grid400_kipf_d5": k1_both(sp.csr_matrix(kipf400), 5, 70)}
    k3_temporal = {"grid400_kipf_d5": k3_case(kipf400, 5, 71)}

    # (b) one train step of each baseline on the heat driver's data (grid400,
    # T 5, tick 100, irregular, seed 0), card against CPU
    hs = sample_times(5.0, 100, "irregular", seed=0)
    sol400, _ = heat_ground_truth(
        as_operator(laplacian_dense(adj400)),
        torch.as_tensor(grid_block_initial_value(20)
                        .astype(np.float32)), hs.t)
    y_train = sol400[..., 0].T[:, hs.id_train].contiguous()
    n_steps = y_train.shape[1] - 1          # teacher steps: 79
    # smoke_references.temporal_problem's (the CPU references')
    problem17 = (kipf400, y_train)

    def temporal_step(rnn_type, fmt, device, split_counts=False):
        return smoke_references.temporal_step(
            rnn_type, fmt, device, problem17,
            kernels.launch_counts if split_counts else None)

    steps17 = {}
    for rnn_type in ("lstm", "gru", "rnn"):
        for fmt, needed in (("dense", None), ("coo", "coo_spmv"),
                            ("bsr", "bsr_spmm")):
            temporal_step(rnn_type, fmt, dev)                  # warm
            ms = [temporal_step(rnn_type, fmt, dev)["ms"] for _ in range(3)]
            kernels.reset_launch_counts()
            gpu = temporal_step(rnn_type, fmt, dev, split_counts=True)
            counts = add_launches(f"the {rnn_type}_gnn {fmt} step",
                                  [needed] if needed else [])
            # the CPU's step: the committed reference
            key = f"temporal/{rnn_type}_{fmt}"
            cpu_loss = float(refs16[f"{key}/loss"])
            loss_err = abs(gpu["loss"] - cpu_loss) / abs(cpu_loss)
            grad_err = max(rel_l1(gpu["grads"][k], v) for k, v in
                           smoke_references.step_grads(refs16, key).items())
            check(loss_err <= 1e-4 and grad_err <= 1e-3,
                  f"{rnn_type}_gnn {fmt} step, card vs CPU: loss "
                  f"{loss_err}, gradients {grad_err}")
            sparse_l = {k: counts[k] for k in ("coo_spmv", "bsr_spmm")}
            fwd_l = {k: gpu["fwd_counts"][k] for k in sparse_l}
            want = {k: (2 * n_steps if k == needed else 0) for k in sparse_l}
            check(sparse_l == want and (needed is None
                                        or fwd_l[needed] == n_steps),
                  f"{rnn_type}_gnn {fmt} step: launches {sparse_l} "
                  f"(forward {fwd_l}), expected {want} with {n_steps} "
                  f"forward")
            steps17[f"{rnn_type}_{fmt}"] = dict(
                loss_rel_err=loss_err, max_grad_rel_l1=grad_err,
                step_ms=ms + [gpu["ms"]],
                sparse_launches=sparse_l, forward_launches=fwd_l,
                transposed_launches={k: sparse_l[k] - fwd_l[k]
                                     for k in sparse_l},
                launches={k: v for k, v in counts.items() if v})

    # (c) the heat driver, 20 iterations of each baseline; the lstm_gnn
    # run again with --dump and --profile_dir (and --viz where matplotlib
    # imports): its losses within 1e-6 of the plain run's
    drv17 = {}
    runs17 = {}
    for label, extra, needed in (
            ("lstm_gnn_coo", ["--sparse", "--sparse_format", "coo"],
             ["coo_spmv"]),
            ("gru_gnn_bsr", ["--sparse", "--sparse_format", "bsr"],
             ["bsr_spmm"]),
            ("rnn_gnn_dense", [], [])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs17[label] = out = heat_experiment(
            "--baseline", label.rsplit("_", 1)[0], *extra, "--niters", "20",
            "--test_freq", "10")
        counts = add_launches(f"the heat driver {label}", needed)
        falls(out["train_losses"], f"the heat driver {label}")
        drv17[label] = dict(train_losses=out["train_losses"],
                            final=out["final"], n_params=out["n_params"],
                            seconds=time.perf_counter() - t0,
                            launches={k: v for k, v in counts.items() if v})
    try:
        import matplotlib  # noqa: F401
        viz_flag = ["--viz"]
    except ImportError:
        viz_flag = []
        print("[17] matplotlib does not import: the --viz "
              "run is not made")
    out_dir = os.path.join(root, "build", "smoke_temporal")
    shutil.rmtree(out_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    cwd = os.getcwd()
    os.makedirs(out_dir)
    os.chdir(out_dir)          # --viz writes figure/ under the cwd
    try:
        t0 = time.perf_counter()
        dumped = heat_experiment(
            "--baseline", "lstm_gnn", "--sparse", "--sparse_format", "coo",
            "--niters", "20", "--test_freq", "10", "--dump",
            "--results_dir", os.path.join(out_dir, "results"),
            "--profile_dir", os.path.join(out_dir, "trace"), *viz_flag)
        dump_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    add_launches("the heat driver lstm_gnn with --dump", ["coo_spmv"])
    plain_losses = runs17["lstm_gnn_coo"]["train_losses"]
    loss_gap = max(abs(a - b) for a, b in zip(dumped["train_losses"],
                                              plain_losses))
    check(len(dumped["train_losses"]) == len(plain_losses)
          and loss_gap <= 1e-6, f"--dump --profile_dir moved the losses: "
          f"{dumped['train_losses']} vs {plain_losses}")
    dump = results_lib.load_results(dumped["results_path"])
    check(dump["v_iter"] == list(range(10, 21, 10))
          and dump["abs_error"][-1] == dumped["final"]["abs_error"]
          and set(dump["model_state_dict"][-1]) == {"gc", "cell", "out"},
          f"the dump does not read back: {dump['v_iter']}")
    summary17 = summarize.main(["--dir", os.path.dirname(
        dumped["results_path"]), "--type", "lstm_gnn"])
    check(summary17["n_runs"] == 1 and summary17["abs_error_mean"]
          == dumped["final"]["abs_error"], f"summarize: {summary17}")
    traces = os.listdir(os.path.join(out_dir, "trace"))
    check(len(traces) == 1 and os.path.getsize(
        os.path.join(out_dir, "trace", traces[0])) > 0,
        f"--profile_dir wrote {traces}")
    drv17["lstm_gnn_coo_dump_profile"] = dict(
        max_loss_gap=loss_gap, seconds=dump_s, trace=traces[0],
        viz=bool(viz_flag), summary=summary17,
        figures=(sorted(os.listdir(os.path.join(out_dir, "figure")))
                 if viz_flag else None))

    # (d) the Lotka-Volterra demo: rk4, then dopri5 with the adjoint; the
    # first 20 iterations' losses against the same run on the CPU
    lv17 = {}
    for label, extra in smoke_references.LV_RUNS.items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = lv.main(["--niters", "40", *extra])
        gpu_s = time.perf_counter() - t0
        add_launches(f"the LV demo {label}", [])
        check(out["device"].startswith("cuda"), f"LV {label} ran on "
              f"{out['device']}")
        # the batches are random: the mean of the first 20 train losses
        # against that of the last 20
        tl = out["train_losses"]
        falls([float(np.mean(tl[:20])), float(np.mean(tl[-20:]))],
              f"the LV demo {label}")
        # the CPU's first 20 losses: the committed reference
        cpu_losses = refs16[f"lv/{label}/train_losses"]
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(out["train_losses"][:20], cpu_losses))
        check(gap <= 1e-4, f"LV {label}: the first 20 losses on the card "
              f"part from the CPU's by {gap}")
        lv17[label] = dict(eval_losses=out["eval_losses"],
                           first_train_losses=out["train_losses"][:5],
                           last_train_loss=out["train_losses"][-1],
                           max_rel_gap_first20_vs_cpu=gap, seconds=gpu_s)

    # (e) the T x alpha sweep on cora, the showcase recipe, seed 0, dense;
    # then --resume, which must rerun no cell
    grid_csv = os.path.join(out_dir, "t_alpha_cora.csv")
    sweep_args = ["--dataset", "cora", *recipe, "--seed", "0",
                  "--T_values", "0.5", "1.2", "--alpha_values", "0.0", "1.0",
                  "--out_csv", grid_csv]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    grid = sweep_t_alpha.main(sweep_args)
    sweep_s = time.perf_counter() - t0
    add_launches("the T x alpha sweep", [])
    calls, dgnn_run = [], dgnn.run
    dgnn.run = lambda a: calls.append(a) or dgnn_run(a)
    try:
        again = sweep_t_alpha.main(sweep_args + ["--resume"])
    finally:
        dgnn.run = dgnn_run
    check(not calls and np.allclose(again, grid, atol=1e-6),
          f"--resume reran {len(calls)} cells")
    with open(os.path.join(root, "results", "t_alpha_grid_cora.csv")) as f:
        rec_rows = [line.strip().split(",") for line in f]
    rec_alpha = [float(a) for a in rec_rows[0][1:]]
    record = {float(r[0]): dict(zip(rec_alpha, map(float, r[1:])))
              for r in rec_rows[1:]}
    cells = [dict(T=t, alpha=a, acc=float(grid[i, j]),
                  tpu_record=record.get(t, {}).get(a))
             for i, t in enumerate((0.5, 1.2))
             for j, a in enumerate((0.0, 1.0))]
    print("[17] temporal baselines, report, LV, sweep (card: " + smi + "): "
          + json.dumps({
              "k1_grid400_kipf_d5": k1_temporal["grid400_kipf_d5"],
              "k3_grid400_kipf_d5": k3_temporal["grid400_kipf_d5"],
              "train_step_card_vs_cpu": steps17, "drivers": drv17,
              "lv": lv17, "sweep": dict(cells=cells, seconds=sweep_s,
                                        resumed_cells_rerun=len(calls)),
              "seconds": time.perf_counter() - t17}))
    torch.cuda.empty_cache()

    mark_phase("18")
    # ---- 18. replica sweeps: the batched kernels, heat --replicas 16, the
    # showcase under --batch_iters --iter 25
    t18 = time.perf_counter()
    from ndcn_tpu_torch.parallel.sweep import replica_l1, stack_models
    from ndcn_tpu_torch.ode import nan_unless
    from ndcn_tpu_torch.train.optim import make_replica_sgd_step

    def batched_record(what, kern, plain, solo, lib_call, stacked=None,
                       emulation=None, **extra):
        """A batched form against its plain version (<= 1e-5), each replica
        against its own one-replica launch (bit-equal), two calls
        bit-equal, the library route and the stacked-width route (<= 1e-5:
        the same function); its times beside R one-replica launches'."""
        y, ref, ones, lib = kern(), plain(), solo(), lib_call()
        torch.cuda.synchronize()
        err, rel = max_rel(y, ref)
        check(rel <= 1e-5, f"{what} disagrees with its plain version: {rel}")
        check(torch.equal(y, kern()), f"{what}: two calls differ")
        check(all(torch.equal(y[i], one) for i, one in enumerate(ones)),
              f"{what}: a replica differs from its own launch")
        check(max_rel(lib, ref)[1] <= 1e-5,
              f"{what}: the library route computes something else")
        rec = dict(extra, max_abs_err=err, rel_err=rel, repeat_equal=True,
                   replicas_equal_solo=True, replicas=int(y.shape[0]),
                   ms=cuda_ms(kern, iters=15), device_ms=queued_ms(kern),
                   plain_ms=cuda_ms(plain, iters=15),
                   solo_ms=cuda_ms(solo, iters=15),
                   solo_device_ms=queued_ms(solo),
                   library_ms=cuda_ms(lib_call, iters=15),
                   library_device_ms=queued_ms(lib_call))
        if emulation is not None:
            rec["rel_err_vs_split_emulation"] = max_rel(y, emulation())[1]
            check(rec["rel_err_vs_split_emulation"] <= 2e-6,
                  f"{what} is not the split product")
        if stacked is not None:
            rec["stacked_rel_err"] = max_rel(stacked(), ref)[1]
            check(rec["stacked_rel_err"] <= 1e-5,
                  f"{what}: the stacked-width route differs")
            rec["stacked_ms"] = cuda_ms(stacked, iters=15)
            rec["stacked_device_ms"] = queued_ms(stacked)
        return rec

    def stack_cols(x):
        """(R, n, d) -> (n, R·d): the replicas side by side as columns."""
        r, n, d = x.shape
        return x.permute(1, 0, 2).reshape(n, r * d)

    def unstack_cols(y, r):
        n = y.shape[0]
        return y.view(n, r, -1).permute(1, 0, 2)

    def k1_batched(mat, d, r, seed):
        op = from_scipy_coo(sp.csr_matrix(mat).astype(np.float32),
                            device=dev)
        x = torch.as_tensor(np.random.RandomState(seed).randn(r, op.n, d)
                            .astype(np.float32), device=dev)
        xs = stack_cols(x).contiguous()
        a = library_csr(op)
        rec = batched_record(
            f"K1 batched n={op.n} d={d} R={r}",
            lambda: coo_spmv.coo_spmv(op, x),
            lambda: coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x,
                                            op.n),
            lambda: [coo_spmv.coo_spmv(op, x[i]) for i in range(r)],
            lambda: unstack_cols(torch.sparse.mm(a, xs), r),
            # K1 as it is on the replicas side by side: a permute, one
            # K1 at width R·d, a permute back
            stacked=lambda: unstack_cols(coo_spmv.coo_spmv(
                op, stack_cols(x).contiguous()), r).contiguous(),
            library="torch.sparse.mm(A, X) on the stacked (n, R·d) X",
            **bound(nbytes(op.row_ptr, op.cols, op.vals, x, x),
                    2 * int(op.cols.shape[0]) * d * r))
        return dict(n=op.n, nnz=int(op.cols.shape[0]), d=d, **rec)

    def replica_weights(rs, r, d):
        weight = torch.as_tensor((rs.randn(r, d, d) / np.sqrt(d))
                                 .astype(np.float32), device=dev)
        b = torch.as_tensor((0.1 * rs.randn(r, d)).astype(np.float32),
                            device=dev)
        return weight, weight.transpose(-1, -2), b

    def k2_batched(mat, d, r, seed):
        rs = np.random.RandomState(seed)
        a = torch.as_tensor(np.asarray(mat, np.float32), device=dev)
        n = a.shape[0]
        h = torch.as_tensor(rs.rand(r, n, d).astype(np.float32), device=dev)
        weight, w, b = replica_weights(rs, r, d)
        rec = batched_record(
            f"K2 batched n={n} d={d} R={r}",
            lambda: fused_rhs.fused_rhs(a, h, w, b),
            lambda: fused_rhs.fused_rhs_plain(a, h, w, b),
            lambda: [fused_rhs.fused_rhs(a, h[i], w[i], b[i])
                     for i in range(r)],
            lambda: torch.relu(torch.baddbmm(b.unsqueeze(1), a @ h, w)),
            emulation=lambda: fused_rhs.fused_rhs_split_plain(a, h, w, b),
            library="relu(baddbmm(b, A @ H, W))",
            **bound(nbytes(a, h, weight, b, h),
                    r * (2 * n * n * d + 2 * n * d * d), "split_tf32"))
        return dict(n=n, d=d, **rec)

    def k3_batched(mat, d, r, seed, transpose=False):
        op = as_operator(sp.csr_matrix(mat), sparse=True, format="bsr",
                         device=dev)
        if transpose:
            op = op.transpose()
        x = torch.as_tensor(np.random.RandomState(seed).rand(r, op.n, d)
                            .astype(np.float32), device=dev)
        xs = stack_cols(x).contiguous()
        lib, lib_name = bsr_library(op.fwd)
        m = op.fwd
        rec = batched_record(
            f"K3 batched n={op.n} d={d} R={r}",
            lambda: bsr_spmm.bsr_spmm(op.fwd, op.bwd, x),
            lambda: bsr_spmm.bsr_spmm_plain(op.fwd, x),
            lambda: [bsr_spmm.bsr_spmm(op.fwd, op.bwd, x[i])
                     for i in range(r)],
            lambda: unstack_cols(lib(xs), r),
            stacked=lambda: unstack_cols(bsr_spmm.bsr_spmm(
                op.fwd, op.bwd, stack_cols(x).contiguous()), r).contiguous(),
            emulation=lambda: bsr_spmm.bsr_spmm_split_plain(op.fwd, x),
            library=f"{lib_name} on the stacked (n, R·d) X",
            **bound(nbytes(m.row_ptr, m.block_cols, m.blocks, x, x),
                    2 * int(m.blocks.shape[0]) * m.block ** 2 * d * r,
                    "split_tf32"))
        plan = bsr_spmm.bsr_batched_plan(m.n_row_blocks, m.block, d, r)
        return dict(n=op.n, nnz_blocks=int(m.blocks.shape[0]), d=d,
                    transpose=transpose, group=plan.group,
                    groups=plan.groups, **rec)

    def k4_batched(mat, d, r, seed):
        op = as_operator(sp.csr_matrix(mat), sparse=True, format="bsr",
                         device=dev)
        rs = np.random.RandomState(seed)
        x = torch.as_tensor(rs.rand(r, op.n, d).astype(np.float32),
                            device=dev)
        weight, w, b = replica_weights(rs, r, d)
        xs = stack_cols(x).contiguous()
        lib, lib_name = bsr_library(op.fwd)
        m = op.fwd
        rec = batched_record(
            f"K4 batched n={op.n} d={d} R={r}",
            lambda: bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, w, b),
            lambda: bsr_spmm.bsr_fused_rhs_plain(op.fwd, x, w, b),
            lambda: [bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x[i], w[i], b[i])
                     for i in range(r)],
            lambda: torch.relu(torch.baddbmm(
                b.unsqueeze(1), unstack_cols(lib(xs), r), w)),
            emulation=lambda: bsr_spmm.bsr_fused_rhs_split_plain(
                op.fwd, x, w, b),
            library=f"relu(baddbmm(b, {lib_name} on the stacked X, W))",
            **bound(nbytes(m.row_ptr, m.block_cols, m.blocks, x, weight, b,
                           x),
                    r * (2 * int(m.blocks.shape[0]) * m.block ** 2 * d
                         + 2 * op.n * d * d), "split_tf32"))
        return dict(n=op.n, d=d, **rec)

    kb = {"k1": {}, "k2": {}, "k3": {}, "k4": {}}
    for r in (1, 16):
        kb["k1"][f"grid400_d20_r{r}"] = k1_batched(grid_lap, 20, r, 80 + r)
        kb["k2"][f"grid400_d20_r{r}"] = k2_batched(grid_lap, 20, r, 81 + r)
        kb["k3"][f"grid400_d20_r{r}"] = k3_batched(grid_lap, 20, r, 82 + r)
        kb["k4"][f"grid400_d20_r{r}"] = k4_batched(grid_lap, 20, r, 83 + r)
    kb["k1"]["cora_d16_r25"] = k1_batched(cora.operator, 16, 25, 84)
    # K1's wide form batched at the raw features' width
    kb["k1"]["cora_d1433_r25"] = k1_batched(cora.operator, 1433, 25, 86)
    torch.cuda.empty_cache()
    # K3's batched form at 25 replicas: replica groups at the hidden width
    # 16, the replica grid at 256 (the showcase's), forward and over Aᵀ
    for d in (16, 256):
        for transpose in (False, True):
            kb["k3"][f"cora_d{d}_r25{'_transpose' if transpose else ''}"] = \
                k3_batched(cora.operator, d, 25, 85 + d, transpose)
    check(kb["k3"]["cora_d16_r25"]["group"] > 1
          and kb["k3"]["cora_d256_r25"]["group"] == 1,
          "K3's batched plan at cora's widths")
    torch.cuda.empty_cache()

    # (b) the heat driver's replica sweep on grid400 (the driver's data: T
    # 5, tick 100, irregular, seed 0), dense --fused_kernel (K2), COO (K1)
    # and BSR (K3, K4 under 'auto')
    x0_h = torch.as_tensor(grid_block_initial_value(20).astype(np.float32),
                           device=dev)
    target_h = sol400[hs.id_train].to(dev)              # (T, 400, 1)
    t_h = hs.t[hs.id_train]
    sweep18 = {}

    def replica_step(op, fused, seeds, max_steps=64):
        """The heat driver's replica step over a stacked model of the
        replicas seeded ``seeds``; returns (step, model, last stats)."""
        model = stack_models([init_ndcn(torch.Generator().manual_seed(s), 1,
                                        20, 1) for s in seeds]).to(dev)
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        last = {}

        def losses():
            out, stats = ndcn_forward(model, op, t_h, x0_h, fused=fused,
                                      max_steps=max_steps, **train_kw)
            last["stats"] = stats
            ls = nan_unless(stats.success,
                            replica_l1(out.transpose(0, 1), target_h))
            return ls, ls

        return make_replica_sgd_step(opt, losses), model, last

    def solo_step(op, fused, seed, max_steps=64):
        model = init_ndcn(torch.Generator().manual_seed(seed), 1, 20, 1,
                          device=dev)
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        last = {}

        def loss():
            out, stats = ndcn_forward(model, op, t_h, x0_h, fused=fused,
                                      max_steps=max_steps, **train_kw)
            last["stats"] = stats
            value = l1_loss(out, target_h)
            return value, value

        return make_sgd_step(opt, loss), last

    def step_launches(step, label):
        """What one step launches: the ATen operators it calls (the launch
        stream the port issues), the port's kernels by their counters, and
        every device kernel in the profiler's trace, those of cuBLAS apart.
        Inside one operator the libraries pick their kernels by size (cuBLAS
        among its gemm and gemv kernels, CUB's radix sort a pass for each
        bits' worth of the largest index), so the device count may part by
        a few kernels between R = 4 and 16: printed, not compared."""
        from torch.profiler import ProfilerActivity, profile
        step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        ours = {k: v for k, v in kernels.launch_counts().items() if v}
        trace = os.path.join(root, "build", "traces", f"{label}.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        names = [e["name"] for e in events if e.get("cat") == "kernel"]
        library = sum(1 for n in names
                      if any(k in n.lower() for k in ("gemm", "gemv",
                                                      "cublas")))
        return dict(kernels=len(names), outside_cublas=len(names) - library,
                    cublas=library, ours=ours,
                    aten_ops=sum(1 for e in events
                                 if e.get("cat") == "cpu_op"
                                 and e["name"].startswith("aten::")))

    for fmt, flags, fused, needed in (
            ("dense", ["--fused_kernel"], "auto", ["fused_rhs_batched"]),
            ("coo", ["--sparse", "--sparse_format", "coo"], False,
             ["coo_spmv_batched"]),
            ("bsr", ["--sparse", "--sparse_format", "bsr",
                     "--fused_kernel"], "auto",
             ["bsr_fused_rhs_batched", "bsr_spmm_batched"])):
        op = as_operator(sp.csr_matrix(grid_lap) if fmt != "dense"
                         else grid_lap, sparse=fmt != "dense", format=fmt,
                         device=dev)
        rec = {}
        # the driver: 16 replicas, 10 iterations
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run("heat", build_parser("heat").parse_args(
            ["--network", "grid", "--n", "400", "--method", "dopri5",
             "--niters", "10", "--test_freq", "5", "--replicas", "16",
             *flags]))
        torch.cuda.synchronize()
        rec["driver_seconds"] = time.perf_counter() - t0
        rec["driver_launches"] = {k: v for k, v in add_launches(
            f"heat --replicas 16 {fmt}", needed).items() if v}
        rec["final"], rec["max_steps"] = out["final"], out["max_steps"]
        losses = out["train_losses"]
        check(all(np.isfinite(losses[-1])) and np.mean(losses[-1])
              < np.mean(losses[0]), f"heat --replicas 16 {fmt}: the train "
              f"losses did not fall {losses}")
        # replicas 0-3 against their runs alone: the first step's losses
        # and NFE, then 3 steps' losses
        step16, _, last16 = replica_step(op, fused, range(16))
        solos = [solo_step(op, fused, s) for s in range(4)]
        first16 = step16()[0].cpu()
        first = [float(s[0]()[0]) for s in solos]
        nfe16 = list(last16["stats"].nfe[:4])
        nfe1 = [s[1]["stats"].nfe for s in solos]
        loss_err = float(np.abs(first16[:4].numpy() - np.array(first)).max()
                         / np.abs(first).max())
        check(loss_err <= 1e-4 and nfe16 == nfe1, f"heat replicas {fmt}: "
              f"replicas 0-3 {first16[:4].tolist()} / NFE {nfe16} against "
              f"their runs alone {first} / {nfe1}")
        drift = [first16[:4].tolist()]
        for _ in range(2):
            drift.append(step16()[0].cpu()[:4].tolist())
        solo_losses = [[first[i]] + [float(solos[i][0]()[0])
                                     for _ in range(2)] for i in range(4)]
        rec.update(first_step_loss_rel_err=loss_err, nfe_replicas_0_3=nfe16,
                   nfe_alone=nfe1,
                   loss_rel_err_3_steps=float(np.max(np.abs(
                       np.array(drift).T - np.array(solo_losses)))
                       / np.abs(solo_losses).max()))
        # time per model-step: the batched step over 16 against a step alone
        rec["batched_step_ms"] = timed_steps(step16)
        rec["model_step_ms"] = rec["batched_step_ms"] / 16
        rec["solo_step_ms"] = timed_steps(solos[0][0])
        # launches per step: 4 replicas against 16 (replicas 0-3 four
        # times over, so the two take the same steps): equal, as one
        # batched program's are
        s4, _, _ = replica_step(op, fused, range(4))
        s16, _, _ = replica_step(op, fused, list(range(4)) * 4)
        rec["launches_r4"] = step_launches(s4, f"replicas_{fmt}_r4")
        rec["launches_r16"] = step_launches(s16, f"replicas_{fmt}_r16")
        same = ("aten_ops", "ours")
        check(all(rec["launches_r4"][k] == rec["launches_r16"][k]
                  for k in same),
              f"heat replicas {fmt}: one step launches "
              f"{rec['launches_r4']} at R = 4 and {rec['launches_r16']} at "
              f"R = 16")
        # a step alone on the same data: its solve reads the observations
        # one at a time, where the batched solve reads every ready one of
        # every replica in one evaluation
        rec["launches_solo"] = step_launches(solos[0][0],
                                             f"replicas_{fmt}_solo")
        rec["profile"] = profile_call(step16, f"train_replicas16_{fmt}",
                                      root)
        sweep18[fmt] = rec
        del step16, solos, s4, s16
        torch.cuda.empty_cache()

    # (c) the showcase recipe under --batch_iters --iter 25 (one of the
    # record's four batches of 25): its mean accuracy within 3 standard
    # errors of 25 models of results/showcase_cora_100.json's 0.8317
    band25 = (0.8317 - 3 * 0.0098 / 5, 0.8317 + 3 * 0.0098 / 5)
    solo_s = float(np.mean([show[f"cora_dense_seed{s}"]["seconds"]
                            for s in (0, 1, 2)]))
    show18 = {}
    for label, extra in (("shared_budget", []),
                         ("budget_buckets_4", ["--budget_buckets", "4"])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = dgnn.run(dgnn.build_parser().parse_args(
            ["--dataset", "cora", *recipe, "--seed", "0", "--batch_iters",
             "--iter", "25", *extra]))
        torch.cuda.synchronize()
        add_launches(f"the showcase under --batch_iters {label}", [])
        mem = out["memory"] or {}
        show18[label] = dict(
            acc_mean=out["acc_mean"], acc_std=out["acc_std"],
            acc_min=out["acc_min"], acc_max=out["acc_max"], dead=out["dead"],
            sweep_seconds=out["sweep_seconds"],
            seconds_per_model=out["sweep_seconds"] / 25,
            solo_seconds_per_model=solo_s,
            run_seconds=time.perf_counter() - t0, max_steps=out["max_steps"],
            buckets=out["buckets"], peak_gb=out["peak_bytes"] / 1e9,
            estimate_gb=mem.get("estimate", 0) / 1e9,
            per_replica_gb=mem.get("per_replica", 0) / 1e9,
            limit_gb=mem.get("limit", 0) / 1e9)
        check(not out["dead"] and band25[0] <= out["acc_mean"] <= band25[1],
              f"the showcase under --batch_iters {label}: mean accuracy "
              f"{out['acc_mean']} (dead {out['dead']}) outside {band25}")
        check(out["peak_bytes"] <= mem.get("limit", 0),
              f"the showcase sweep {label} peaked over the guard's limit")
        torch.cuda.empty_cache()

    # (d) the classification path's sparse sweeps: the showcase recipe on
    # BSR (K3's batched form at the hidden width 256), and DeepGCN2 on COO
    # (the shared raw features times A once an epoch for all replicas:
    # K1's wide form at d = 1433, one replica; the hidden width batched)
    sparse18 = {}
    for label, argv, needed in (
            ("showcase_bsr", [*recipe, "--sparse", "--sparse_format", "bsr"],
             ["bsr_spmm_batched"]),
            ("deepgcn2_coo", ["--model", "DeepGCN2", "--sparse", "--epochs",
                              "10", "--data_dir", os.path.join(root,
                                                               "data")],
             ["coo_spmv_wide", "coo_spmv_batched"])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = dgnn.run(dgnn.build_parser().parse_args(
            ["--dataset", "cora", *argv, "--seed", "0", "--batch_iters",
             "--iter", "25"]))
        torch.cuda.synchronize()
        counts = add_launches(f"{label} under --batch_iters", needed)
        losses = out["train_losses"]
        check(not out["dead"] and losses[-1] < losses[0],
              f"{label} under --batch_iters: train losses {losses[0]} -> "
              f"{losses[-1]}, dead {out['dead']}")
        sparse18[label] = dict(
            acc_mean=out["acc_mean"], acc_std=out["acc_std"],
            first_loss=losses[0], last_loss=losses[-1],
            sweep_seconds=out["sweep_seconds"],
            seconds_per_model=out["sweep_seconds"] / 25,
            run_seconds=time.perf_counter() - t0, max_steps=out["max_steps"],
            launches={k: v for k, v in counts.items() if v})
        torch.cuda.empty_cache()
    sparse18["showcase_bsr"]["dense_seconds_per_model"] = \
        show18["shared_budget"]["seconds_per_model"]
    check(band25[0] <= sparse18["showcase_bsr"]["acc_mean"] <= band25[1],
          f"the showcase on BSR under --batch_iters: mean accuracy "
          f"{sparse18['showcase_bsr']['acc_mean']} outside {band25}")
    print("[18] replica sweeps (card: " + smi + "): " + json.dumps({
        "kernels": kb, "heat_replicas16": sweep18, "showcase25": show18,
        "sparse_sweeps25": sparse18, "showcase_band": band25,
        "seconds": time.perf_counter() - t18}))

    mark_phase("19")
    # ---- 19. the mesh: K1 / K1ᵀ / K1-fm on row blocks, the sharded drivers
    import torch.distributed as dist

    from ndcn_tpu_torch.parallel import coo_shard
    from ndcn_tpu_torch.parallel.mesh import make_mesh, process_group

    t19 = time.perf_counter()
    P19 = 4
    blocks19 = [coo_shard.shard_coo_at(op_big, P19, r, None)
                for r in range(P19)]
    n_pad19 = blocks19[0].n_pad
    x19 = torch.as_tensor(np.random.RandomState(19).randn(op_big.n, 20)
                          .astype(np.float32), device=dev)
    xT19 = torch.zeros((24, op_big.n), device=dev)
    xT19[:20] = x19.t()

    def rowblock_case(form, transpose, bf16):
        """One kernel on each of the 4 row blocks of the 200k operator (A's,
        or Aᵀ's with ``transpose``) against the gathered table: the blocks'
        outputs concatenate bit-equal to the whole operator's launch and
        come within 1e-6·max|y| of the plain version; each block's times,
        bound and library call (``torch.sparse.mm`` on the block's CSR
        against the table), and their sums beside the whole launch's."""
        whole = op_big.transpose() if transpose else op_big
        parts = [b.block_t if transpose else b.block for b in blocks19]
        rows19 = [b.stop - b.start for b in blocks19]
        with gather_mode(False, bf16), torch.no_grad():
            if form == "k1":
                table = torch.cat([x19, x19.new_zeros((n_pad19 - op_big.n,
                                                       20))])
                run = lambda bl: coo_spmv._apply(bl, table)   # noqa: E731
                whole_run = lambda: coo_spmv._apply(whole, x19)  # noqa: E731
                ref = coo_spmv.coo_spmv_plain(whole.rows, whole.cols,
                                              whole.vals, x19, whole.n, bf16)
                y = torch.cat([run(bl)[:m] for bl, m in zip(parts, rows19)])
                y_whole = whole_run()

                def plain(bl):
                    return coo_spmv.coo_spmv_plain(bl.rows, bl.cols, bl.vals,
                                                   table, bl.n, bf16)
            else:
                packed = coo_spmv.pack_rows(xT19, bf16)
                table = torch.cat([packed, packed.new_zeros(
                    (n_pad19 - op_big.n, 24))])
                run = lambda bl: coo_spmv.gather_T(bl, table)  # noqa: E731
                whole_run = lambda: coo_spmv.gather_T(  # noqa: E731
                    whole, table[:op_big.n])
                ref = coo_spmv.coo_spmv_T_plain(whole.rows, whole.cols,
                                                whole.vals, xT19, whole.n,
                                                bf16)
                y = torch.cat([run(bl)[:, :m] for bl, m in zip(parts, rows19)],
                              dim=1)
                y_whole = coo_spmv._apply_T(whole, xT19)

                def plain(bl):
                    return coo_spmv.coo_spmv_T_plain(
                        bl.rows, bl.cols, bl.vals, table.t().float(), bl.n,
                        bf16)
            torch.cuda.synchronize()
            what = f"row-block {form} bf16={bf16} transpose={transpose}"
            check(torch.equal(y, y_whole),
                  f"{what}: the blocks part from the whole launch")
            err, rel = max_rel(y, ref)
            check(rel <= 1e-6, f"{what} disagrees with its plain version: "
                               f"{rel}")
            check(torch.equal(run(parts[0]), run(parts[0])),
                  f"{what}: two calls differ")
            per_block = []
            for bl in parts:
                vals = coo_spmv.round_bf16(bl.vals) if bf16 else bl.vals
                a = torch.sparse_csr_tensor(bl.row_ptr, bl.cols, vals,
                                            size=(bl.n, bl.n_table))
                tf = (coo_spmv.round_bf16(table) if bf16 and form == "k1"
                      else table.float())

                def library(a=a, tf=tf):
                    out = torch.sparse.mm(a, tf)
                    return out if form == "k1" else out.t().contiguous()

                out = run(bl)
                nnz = int(bl.cols.shape[0])
                per_block.append(dict(
                    rows=bl.n, nnz=nnz, ms=cuda_ms(lambda bl=bl: run(bl),
                                                   iters=15),
                    device_ms=queued_ms(lambda bl=bl: run(bl)),
                    plain_ms=cuda_ms(lambda bl=bl: plain(bl), iters=15),
                    library_ms=cuda_ms(library, iters=15),
                    library_device_ms=queued_ms(library),
                    **bound(nbytes(bl.row_ptr, bl.cols, bl.vals, table, out),
                            2 * nnz * table.shape[1])))
            summed = {k: sum(b[k] for b in per_block)
                      for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "bound_ms")}
            return dict(summed, max_abs_err=err, rel_err=rel,
                        bound_by=("bytes" if all(b["bound_by"] == "bytes"
                                                 for b in per_block)
                                  else "operations"),
                        whole_ms=cuda_ms(whole_run, iters=15),
                        whole_device_ms=queued_ms(whole_run),
                        blocks=per_block, repeat_equal=True,
                        concat_equal_whole=True)

    k19 = {}
    for form in ("k1", "k1fm"):
        for bf16 in (False, True):
            k19[f"{form}_{'bf16' if bf16 else 'f32'}"] = {
                label: rowblock_case(form, transpose, bf16)
                for label, transpose in (("fwd", False), ("transpose", True))}
    # the batched form on the row blocks (R = 4 replicas, the data x model
    # mesh's product): each replica bit-equal to its own block launch, the
    # blocks to the whole batched launch
    xr19 = torch.stack([x19 * (i + 1) for i in range(4)])
    tab19 = torch.cat([xr19, xr19.new_zeros((4, n_pad19 - op_big.n, 20))], 1)
    with torch.no_grad():
        ys = [coo_spmv._apply(b.block, tab19) for b in blocks19]
        check(all(torch.equal(y[i], coo_spmv._apply(b.block,
                                                    tab19[i].contiguous()))
                  for y, b in zip(ys, blocks19) for i in range(4)),
              "row-block batched K1: a replica parts from its own launch")
        y = torch.cat([y[:, :b.stop - b.start] for y, b in zip(ys, blocks19)],
                      1)
        check(torch.equal(y, coo_spmv._apply(op_big, xr19)),
              "row-block batched K1: the blocks part from the whole launch")
        err, rel = max_rel(y, coo_spmv.coo_spmv_plain(
            op_big.rows, op_big.cols, op_big.vals, xr19, op_big.n))
        check(rel <= 1e-6, f"row-block batched K1 vs plain: {rel}")
        k19["k1_batched_r4"] = dict(
            max_abs_err=err, rel_err=rel, replicas=4,
            device_ms=sum(queued_ms(lambda b=b: coo_spmv._apply(b.block,
                                                                tab19))
                          for b in blocks19),
            solo_device_ms=sum(queued_ms(
                lambda b=b, i=i: coo_spmv._apply(b.block,
                                                 tab19[i].contiguous()))
                for b in blocks19 for i in range(4)),
            whole_device_ms=queued_ms(lambda: coo_spmv._apply(op_big, xr19)),
            bound_ms=sum(bound(nbytes(b.block.row_ptr, b.block.cols,
                                      b.block.vals, tab19, ys[0]),
                               2 * int(b.block.cols.shape[0]) * 80)
                         ["bound_ms"] for b in blocks19))
    del xr19, tab19, ys, y
    csr_tensors.clear()
    torch.cuda.empty_cache()

    # b. the scale driver with --mesh at 200k on a one-rank NCCL group
    # (ground truth cached for the three runs), and without it
    gt19 = os.path.join(root, "build", "smoke_mesh_gt.npz")
    if os.path.exists(gt19):
        os.remove(gt19)
    mesh_argv = ("--n", "200000", "--iters", "5", "--gt_cache", gt19)
    runs19 = {}
    with process_group(dev):
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"the mesh runs on {dist.get_backend()}")
        for label, extra, needed in (
                ("mesh_nd", (), ["coo_spmv_rowblock", "coo_spmv"]),
                ("mesh_feature_major", ("--layout", "feature_major"),
                 ["coo_spmv_T_rowblock", "coo_spmv_T_pack"])):
            rec, counts = scale_run(f"200k --mesh {label}", needed,
                                    *mesh_argv, "--mesh", *extra)
            check(rec["mesh_backend"] == "nccl" and rec["mesh_devices"] == 1
                  and rec["mesh_parity"] < 1e-4,
                  f"200k --mesh {label}: {rec['mesh_backend']}, parity "
                  f"{rec['mesh_parity']}")
            check(rec["train_losses"][-1] < rec["train_losses"][0],
                  f"200k --mesh {label}: the train loss did not fall")
            runs19[label] = dict(scale_summary(rec, counts),
                                 mesh_parity=rec["mesh_parity"],
                                 mesh_devices=rec["mesh_devices"],
                                 mesh_backend=rec["mesh_backend"])
        # one steady sharded train step: its launches and the busy share
        rs_big = coo_shard.shard_coo_rows(op_big, make_mesh(dev))
        model19 = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                            device=dev)
        opt19 = torch_adam(model19.parameters(), 0.01, 1e-3)

        def loss19():
            out, _ = ndcn_forward(model19, rs_big, t_train, x0_big,
                                  max_steps=budget, **train_kw)
            loss = l1_loss(out, target_big)
            return loss, loss

        step19 = make_sgd_step(opt19, loss19)
        step19()
        kernels.reset_launch_counts()
        step19()
        torch.cuda.synchronize()
        per_step19 = kernels.launch_counts()
        check(per_step19["coo_spmv_rowblock"] > 0
              and per_step19["coo_spmv"] == 0,
              f"the sharded step launched K1 {per_step19['coo_spmv']} times "
              f"on the whole operator and "
              f"{per_step19['coo_spmv_rowblock']} on its row block")
        # the same step unsharded, from the same weights, after as many
        # steps; then the two alternately, in one process
        model19u = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                             device=dev)
        opt19u = torch_adam(model19u.parameters(), 0.01, 1e-3)

        def loss19u():
            out, _ = ndcn_forward(model19u, op_big, t_train, x0_big,
                                  max_steps=budget, **train_kw)
            loss = l1_loss(out, target_big)
            return loss, loss

        step19u = make_sgd_step(opt19u, loss19u)
        step19u()
        step19u()

        def timed19(fn):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        alt19 = {"sharded": [], "unsharded": []}
        for which in ("sharded", "unsharded", "unsharded", "sharded") * 3:
            alt19[which].append(timed19(step19 if which == "sharded"
                                        else step19u))
        check(all(torch.equal(p, q) for p, q in zip(
            model19.parameters(), model19u.parameters())),
              "the one-rank sharded steps part from the unsharded ones")
        alt19["median_ratio"] = (statistics.median(alt19["sharded"])
                                 / statistics.median(alt19["unsharded"]))
        prof19 = profile_call(step19, "train_200k_mesh", root)
        del rs_big, model19, opt19, model19u, opt19u
    check(not dist.is_initialized(), "the process group outlived [19]")
    rec_u, counts_u = scale_run("200k without --mesh", ["coo_spmv"],
                                *mesh_argv)
    runs19["unsharded"] = scale_summary(rec_u, counts_u)
    runs19["steps_per_s_sharded_over_unsharded"] = (
        runs19["mesh_nd"]["train_steps_per_sec"]
        / rec_u["train_steps_per_sec"])

    # c. the heat driver with --mesh on one rank: the JAX notice, and the
    # losses of the run without it
    dyn19 = {}
    for label, extra in (("mesh", ("--mesh",)), ("plain", ())):
        kernels.reset_launch_counts()
        out = run("heat", build_parser("heat").parse_args([
            "--niters", "20", "--test_freq", "10", "--method", "dopri5",
            "--sparse", "--sparse_format", "coo", *extra]))
        dyn19[label] = dict(train_losses=out["train_losses"],
                            launches=add_launches(f"heat {label}",
                                                  ["coo_spmv"]))
    check(dyn19["mesh"]["train_losses"] == dyn19["plain"]["train_losses"],
          "heat --mesh on one rank parts from the run without it")
    print("[19] mesh (card: " + smi + "): " + json.dumps({
        "row_blocks": P19, "kernels": k19, "scale": runs19,
        "launches_per_mesh_step": per_step19, "mesh_step_profile": prof19,
        "step_ms_alternating": alt19,
        "heat": dyn19, "seconds": time.perf_counter() - t19}))

    mark_phase("20")
    # [23] / [24] and [21] in two processes of their own beside [20], [22]
    # and [25] (``side_main``): the phases that time a kernel or a library
    # call ([3]-[19]) are done, and every time from here to [25] is a
    # host-clock one taken under the other processes' load (``LOADED``)
    side_scan = SideProcess("scan", root)
    side_replicas = SideProcess("replicas", root)
    # ---- 20. the serving artifact: export, then serve in a fresh process
    from ndcn_tpu_torch.data import load_planetoid
    from ndcn_tpu_torch.serve import export_ndcn, save_artifact
    from ndcn_tpu_torch.tools.serve_artifact import host_reads

    t20 = time.perf_counter()
    exp_dir = os.path.join(root, "build", "smoke_export")
    shutil.rmtree(exp_dir, ignore_errors=True)
    os.makedirs(exp_dir)
    kw20 = dict(rtol=0.01, atol=0.001, method="dopri5")
    settings20 = {   # model, operator, grid, fused, request, its kernel
        "grid400_dense_k2": (model_grid, op_grid, fx["t"], "auto",
                             fx["x0"], "fused_rhs"),
        "grid400_bsr_k3": (model_grid, op_gb, fx["t"], False, fx["x0"],
                           "bsr_spmm"),
        "grid400_bsr_k4": (model_grid, op_gb, fx["t"], "auto", fx["x0"],
                           "bsr_fused_rhs"),
        "200k_coo_k1": (model_big, op_big, splits.t, False,
                        np.random.RandomState(0).uniform(
                            0.0, 25.0, (op_big.n, 1)).astype(np.float32),
                        "coo_spmv")}
    art20, served20 = {}, []   # the records; (artifact, request) to serve
    for label, (mdl, op20, vt20, fused, x0, kname) in settings20.items():
        t0 = time.perf_counter()
        blob = export_ndcn(mdl, op20, vt20, x0.shape, fused=fused, **kw20)
        export_s = time.perf_counter() - t0
        path = os.path.join(exp_dir, f"{label}.pt2")
        save_artifact(path, blob)
        np.save(os.path.join(exp_dir, f"{label}_x0.npy"), x0)
        served20 += [path, os.path.join(exp_dir, f"{label}_x0.npy")]
        # the in-process server on the same weights: one request counted,
        # then ten timed
        srv = make_server(mdl, op20, vt20, fused=fused, **kw20)
        kernels.reset_launch_counts()
        with host_reads() as srv_reads:
            out_s, ok_s = srv(x0)
        torch.cuda.synchronize()
        counts = add_launches(f"{label} in-process", [kname])
        st = srv.last_stats
        check(ok_s, f"{label}: the server's solve failed")
        np.save(os.path.join(exp_dir, f"{label}_server.npy"),
                out_s.cpu().numpy())
        srv_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            srv(x0)
            torch.cuda.synchronize()
            srv_ms.append((time.perf_counter() - t0) * 1e3)
        art20[label] = dict(
            bytes=len(blob), export_s=export_s, nfe_server=st.nfe,
            accepted=st.n_accepted, rejected=st.n_rejected,
            server_median_ms=statistics.median(srv_ms),
            server_latency_ms=srv_ms, server_host_reads=srv_reads[0],
            # the loop's own reads: while_loop's predicate an iteration and
            # once more, torch.cond's an iteration (the server's count also
            # holds its copies of x0, the grid and the tableau to the card)
            host_reads_expected=2 * (st.n_accepted + st.n_rejected
                                     + len(vt20) - 1) + 1,
            server_launch_counts={k: v for k, v in counts.items() if v})
        del blob, srv, out_s
        torch.cuda.empty_cache()

    # the dgnn driver's --export on cora (the showcase recipe, 2 epochs)
    cora_path = os.path.join(exp_dir, "cora.pt2")
    _, out20 = driver("the cora showcase with --export", [], "--dataset",
                      "cora", *recipe, "--seed", "0", "--epochs", "2",
                      "--export", cora_path)
    check(out20.get("export") == cora_path, "dgnn --export wrote nothing")
    cora20 = load_planetoid("cora", alpha=0.0,
                            data_dir=os.path.join(root, "data"))
    np.save(os.path.join(exp_dir, "cora_x0.npy"), cora20.features)
    served20 += [cora_path, os.path.join(exp_dir, "cora_x0.npy")]

    # every artifact served by tools.serve_artifact in one fresh process
    # that imports torch and the kernels' operators only
    r = subprocess.run(
        [sys.executable, "-m", "ndcn_tpu_torch.tools.serve_artifact",
         *served20, "--requests", "10", "--answers", exp_dir],
        capture_output=True, text=True, timeout=900, cwd=root)
    check(r.returncode == 0, f"serving the artifacts failed: "
          f"{r.stderr[-3000:]}")
    recs20 = {os.path.splitext(rec["artifact"])[0]: rec for rec in
              map(json.loads, r.stdout.strip().splitlines())}
    for label, rec in recs20.items():
        check(rec["success"], f"{label}: the artifact's solve failed")
        check(not rec["model_code_imported"], f"{label}: the serving "
              f"process imported {rec['model_code_imported']}")
        for name, c in rec["launch_counts"].items():
            main_launches[name] += c
    artifact_launches = {}
    for label, (*_, kname) in settings20.items():
        rec, a = recs20[label], art20[label]
        launched = rec["launch_counts"].get(kname, 0)
        check(launched > 0, f"{label}: the artifact never launched {kname}")
        artifact_launches[kname] = launched
        diff = float(np.abs(
            np.load(os.path.join(exp_dir, f"{label}.npy"))
            - np.load(os.path.join(exp_dir, f"{label}_server.npy"))).max())
        check(diff <= 1e-6, f"{label}: the artifact parts from the server "
              f"by {diff}")
        # one launch of the kernel an RHS evaluation: its launches are the
        # artifact's NFE
        check(launched == a["nfe_server"]
              == a["server_launch_counts"][kname],
              f"{label}: NFE {launched} in the artifact, "
              f"{a['nfe_server']} in process")
        a.update(max_abs_diff=diff, nfe_artifact=launched,
                 success=rec["success"], median_ms=rec["median_ms"],
                 latency_ms=rec["latency_ms"],
                 first_request_ms=rec["first_request_ms"],
                 load_s=rec["load_s"], host_reads=rec["host_reads"],
                 launch_counts=rec["launch_counts"])
    rec = recs20["cora"]
    pred = np.load(os.path.join(exp_dir, "cora.npy")).argmax(1)
    acc20 = float((pred[cora20.idx_test]
                   == cora20.labels[cora20.idx_test]).mean())
    check(abs(acc20 - out20["rows"][-1][2]) < 0.01,
          f"the cora artifact's accuracy {acc20} against the driver's "
          f"{out20['rows'][-1][2]}")
    art20["cora_dgnn_export"] = dict(
        bytes=rec["bytes"], artifact_test_acc=acc20,
        driver_test_acc=out20["rows"][-1][2], median_ms=rec["median_ms"],
        host_reads=rec["host_reads"], launch_counts=rec["launch_counts"])
    shutil.rmtree(exp_dir, ignore_errors=True)
    print("[20] serving artifact (card: " + smi + "): " + json.dumps(dict(
        art20, times=LOADED, seconds=time.perf_counter() - t20)))

    mark_phase("22")
    # ---- 22. the model axis's paths (ROADMAP §1 entry 11c′): the
    # continuous adjoint, the lstm_gnn step and the GCN zoo on row-sharded
    # COO operators over the one-rank NCCL world group itself (not the None
    # a group of one gets), so that every collective of these paths runs
    # on the card; each step against the same step unsharded
    from ndcn_tpu_torch.models.gcn_zoo import build_zoo_model
    from ndcn_tpu_torch.parallel.mesh import all_reduce_grads
    from ndcn_tpu_torch.train.losses import accuracy

    t22 = time.perf_counter()
    paths22, per_step22 = {}, {}

    def world_rows(op):
        """``op``'s one row block over the one-rank world group."""
        return coo_shard.shard_coo_at(op, 1, 0, None)._replace(
            group=dist.group.WORLD)

    def timed_step(step, op):
        """(loss, gradients, extra, ms) of ``step(op)``, which backprops
        its loss and returns (loss, model, extra); the gradients summed
        over the operator's group, as ``make_sgd_step`` sums them."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, model, extra = step(op)
        all_reduce_grads(model.parameters(), coo_shard.node_group(op))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (float(loss.detach()),
                [p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p) for p in model.parameters()],
                extra, ms)

    def model_axis_path(label, step, whole_op, needed, absent=()):
        """The unsharded step (warm, then the reference), then the step on
        the world group's row block, its launches counted: within 1e-4 of
        the reference (loss and every gradient, rel-L1), the same
        ``extra`` (NFE), the row-block kernels of ``needed`` launched and
        none of ``absent`` (the whole operator's K1)."""
        sharded_op = world_rows(whole_op)
        timed_step(step, whole_op)
        ref = timed_step(step, whole_op)
        kernels.reset_launch_counts()
        got = timed_step(step, sharded_op)
        counts = add_launches(f"[22] {label}", needed)
        check(not any(counts[k] for k in absent),
              f"[22] {label} launched {({k: counts[k] for k in absent})}")
        loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
        grad_rel = max(rel_l1(a, b) for a, b in zip(got[1], ref[1]))
        check(loss_rel <= 1e-4 and grad_rel <= 1e-4 and got[2] == ref[2],
              f"[22] {label}: the row block's step against the unsharded "
              f"one: loss {loss_rel}, gradients {grad_rel}, {got[2]} vs "
              f"{ref[2]}")
        per_step22[label] = {k: v for k, v in counts.items() if v}
        paths22[label] = dict(loss=got[0], loss_rel=loss_rel,
                              max_grad_rel_l1=grad_rel, **got[2],
                              ms=got[3], unsharded_ms=ref[3],
                              launches=per_step22[label])

    def adjoint_step(op):
        model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=dev)
        out, stats = ndcn_forward(model, op, t_train, x0_big, adjoint=True,
                                  max_steps=budget, **train_kw)
        loss = l1_loss(out, target_big, coo_shard.node_group(op))
        loss.backward()
        check(stats.success and all(b.success for b in stats.backward),
              "[22] the 200k adjoint solve failed")
        return loss, model, dict(
            nfe=stats.nfe, nfe_backward=sum(b.nfe for b in stats.backward))

    kipf22 = from_scipy_coo(sp.csr_matrix(kipf400), device=dev)
    y22 = y_train.to(dev)

    def lstm_step(op):
        model = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5,
                                  400, 10, "lstm", device=dev)
        pred = temporal_gcn_forward(
            model, op, y22[:, :-1], "lstm", dropout=0.1, deterministic=False,
            generator=torch.Generator().manual_seed(1))
        loss = l1_loss(pred, y22[:, 1:], coo_shard.node_group(op))
        loss.backward()
        return loss, model, {}

    cora22 = from_scipy_coo(cora.operator, device=dev)
    x_cora = torch.as_tensor(cora.features, device=dev)
    y_cora = torch.as_tensor(cora.labels, device=dev).long()
    idx_cora = torch.as_tensor(cora.idx_train, device=dev).long()

    def zoo_epoch(name):
        def epoch(op):
            """One epoch of the dgnn driver's: a train step with dropout
            (the generator's masks), then the deterministic re-forward."""
            group = coo_shard.node_group(op)
            model = build_zoo_model(
                name, x_cora.shape[1], 16, int(cora.labels.max()) + 1,
                x_cora.shape[0], 2, generator=torch.Generator().manual_seed(
                    0), dropout=0.5).to(dev)
            logits = model(op, x_cora, torch.Generator().manual_seed(1),
                           False)
            loss = cross_entropy(logits[idx_cora], y_cora[idx_cora], group)
            loss.backward()
            with torch.no_grad():
                accuracy(model(op, x_cora), y_cora, group)
            return loss, model, {}
        return epoch

    with process_group(dev):
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"[22] runs on {dist.get_backend()}")
        model_axis_path("adjoint_200k_coo", adjoint_step, op_big,
                        ["coo_spmv_rowblock"], ["coo_spmv"])
        model_axis_path("lstm_gnn_grid400_coo", lstm_step, kipf22,
                        ["coo_spmv_rowblock"], ["coo_spmv"])
        for name in ("GCN", "DeepGCN2"):
            model_axis_path(f"{name}_cora_coo", zoo_epoch(name), cora22,
                            ["coo_spmv_rowblock"]
                            + (["coo_spmv_wide_rowblock"]
                               if name == "DeepGCN2" else []), ["coo_spmv"])
        # DeepGCN3 multiplies its rows of AW ∘ A by the gathered state: a
        # dense product, as in the JAX package; no K1, whole or row block
        model_axis_path("DeepGCN3_cora_coo", zoo_epoch("DeepGCN3"), cora22,
                        [], ["coo_spmv", "coo_spmv_rowblock"])
        # (d) the drivers' newly allowed combinations with --mesh on the
        # one-rank group: the JAX notice, and the losses of the run
        # without it
        drivers22 = {}
        for label, call, argv in (
                ("heat_adjoint", "heat", ["--adjoint"]),
                ("heat_lstm_gnn", "heat", ["--baseline", "lstm_gnn"]),
                ("dgnn_GCN", "dgnn", ["--model", "GCN"]),
                ("dgnn_batch_DeepGCN2", "dgnn",
                 ["--model", "DeepGCN2", "--batch_iters", "--iter", "2"])):
            got = {}
            for mode, extra in (("mesh", ["--mesh"]), ("plain", [])):
                kernels.reset_launch_counts()
                if call == "heat":
                    out = run("heat", build_parser("heat").parse_args([
                        "--niters", "4", "--test_freq", "2", "--method",
                        "dopri5", "--sparse", "--sparse_format", "coo",
                        *argv, *extra]))
                else:
                    out = dgnn.main(["--dataset", "cora", "--epochs", "3",
                                     "--sparse", "--data_dir",
                                     os.path.join(root, "data"), *argv,
                                     *extra])
                add_launches(f"[22] {label} {mode}", ["coo_spmv"])
                got[mode] = out["train_losses"]
            check(got["mesh"] == got["plain"],
                  f"[22] {label}: --mesh on one rank parts from the run "
                  f"without it: {got}")
            drivers22[label] = got["mesh"]
    check(not dist.is_initialized(), "the process group outlived [22]")
    print("[22] the model axis's paths on a one-rank NCCL group (card: "
          + smi + "): " + json.dumps(dict(
              paths=paths22, drivers=drivers22, times=LOADED,
              seconds=time.perf_counter() - t22)))
    del kipf22, cora22, x_cora
    torch.cuda.empty_cache()

    mark_phase("25")
    # ---- 25. the scale-record tools, analyze_mesh_tax (on a one-rank NCCL
    # group of its own, as [19] and [22]) and the quickstart
    tools25 = tools_phase(dev, root, add_launches,
                          res10["nfe_per_step"][0], smi)
    print("[25] the record tools, analyze_mesh_tax, the quickstart (card: "
          + smi + "; beside [21] / [23] / [24]'s processes): "
          + json.dumps(dict(tools25, times=LOADED)))

    mark_phase("21,23-24")
    # ---- 21, 23-24. the Adams family and the adjoint under replicas, and
    # the Adams and feature-major artifacts; the scan path, --scan_chunk and
    # its Adams, adjoint and mesh settings: from the processes started
    # after [19]
    rep_rec = side_replicas.result()
    scan_rec = side_scan.result()
    scan23, scan24 = scan_rec["scan23"], scan_rec["scan24"]
    for name in main_launches:
        main_launches[name] += (scan_rec["launches"][name]
                                + rep_rec["launches"][name])
    rep21, art21 = rep_rec["rep21"], rep_rec["art21"]
    for label, (fmt, *_) in smoke_references.REPLICA_SETTINGS.items():
        rep21[label]["model_step_ms_18"] = sweep18.get(fmt, {}).get(
            "model_step_ms")
    artifact_launches.update(art21.pop("launches_in_artifact"))
    print("[21] Adams and adjoint under replicas, Adams and feature-major "
          "artifacts (card: " + smi + "; in a process of its own beside "
          "[20], [22], [25]): " + json.dumps(dict(
              replicas=rep21, times=LOADED, **art21)))
    print("[23] the scan path and --scan_chunk (card: " + smi + "; beside "
          "[20]-[22], in a process of its own): " + json.dumps(
              dict(scan23, times=LOADED)))
    print("[24] the Adams family, the adjoint and the mesh under "
          "--scan_chunk (card: " + smi + "; with [23]): "
          + json.dumps(dict(scan24, times=LOADED)))

    mark_phase("p")
    # ---- p. where the time goes
    for label, srv, x0 in (("grid400", server, fx["x0"]),
                           ("200k", server_big, requests[0])):
        print(f"[p] serve {label}: " + json.dumps(
            profile_call(lambda: srv(x0), f"serve_{label}", root)))

    def one_step(model, op, vt, x0, target, fused, max_steps, layout="auto",
                 wide=False, bf16=False):
        opt = torch_adam(model.parameters(), 0.01, 1e-3)

        def loss_fn():
            out, _ = ndcn_forward(model, op, vt, x0, fused=fused,
                                  max_steps=max_steps, layout=layout,
                                  **train_kw)
            loss = l1_loss(out, target)
            return loss, loss

        step = make_sgd_step(opt, loss_fn)

        def in_mode():
            with gather_mode(wide, bf16):
                return step()

        return in_mode

    big = (op_big, t_train, x0_big, target_big, False, budget)
    step_launches = {}   # the kernels' launches in one steady train step
    for label, args, mode in (
            ("grid400_dense", (op_g, gx["t"], x0_g, target_g, "auto", 64), {}),
            ("grid400_bsr_k3", (op_gb, gx["t"], x0_g, target_g, False, 64),
             {}),
            ("grid400_bsr_k4", (op_gb, gx["t"], x0_g, target_g, True, 64),
             {}),
            ("200k_coo", big, {}),
            ("200k_coo_bf16", big, dict(bf16=True)),
            ("200k_fm_wide", big, dict(layout="feature_major", wide=True)),
            ("1m_feature_major", (prob.op, prob.t_train, prob.x0, target_1m,
                                  False, budget_1m), {})):
        model = (params_from_jax(g_tree, device=dev) if "grid" in label
                 else copy.deepcopy(model_1m if "1m" in label else model_p))
        step = one_step(model, *args, **mode)
        step()
        kernels.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        step_launches[label] = kernels.launch_counts()
        print(f"[p] train {label}: " + json.dumps(
            dict(profile_call(step, f"train_{label}", root),
                 launches_per_step=step_launches[label])))

    # one steady cora differential_gcn epoch (the driver's defaults:
    # hidden 16, dropout 0.5, T 2, tick 5, rtol = atol = 0.1; train step,
    # eval re-forward, the five statistics read once) on each format
    epoch_launches = {}
    x_c = torch.as_tensor(cora.features, device=dev)
    lab_c = torch.as_tensor(cora.labels, device=dev).long()
    idx_tr = torch.as_tensor(cora.idx_train, device=dev).long()
    idx_va = torch.as_tensor(cora.idx_val, device=dev).long()
    vt_c = np.linspace(0, 2.0, 5).astype(np.float32)
    for fmt in ("dense", "coo", "bsr"):
        op_c = as_operator(cora.operator, sparse=fmt != "dense", format=fmt,
                           device=dev)
        model = init_ndcn(torch.Generator().manual_seed(0), 1433, 16, 7,
                          encoder_layers=1, device=dev)
        kw = dict(rtol=0.1, atol=0.1, method="dopri5", terminal=True)
        ms_c = probe_step_budget(
            lambda: ndcn_forward(model, op_c, vt_c, x_c, nondiff=True,
                                 max_steps=1 << 14, **kw)[1],
            floor=8, headroom=2.5, slack=4, quantum=4)
        opt = torch_adam(model.parameters(), 0.01, 5e-4)
        gen = torch.Generator().manual_seed(1)

        def epoch():
            opt.zero_grad(set_to_none=True)
            out, _ = ndcn_forward(model, op_c, vt_c, x_c, dropout=0.5,
                                  rng=gen, max_steps=ms_c, **kw)
            loss = cross_entropy(out[idx_tr], lab_c[idx_tr])
            loss.backward()
            opt.step()
            with torch.no_grad():
                ev, _ = ndcn_forward(model, op_c, vt_c, x_c, max_steps=ms_c,
                                     **kw)
                return torch.stack([
                    loss.detach(), cross_entropy(ev[idx_tr], lab_c[idx_tr]),
                    (ev[idx_tr].argmax(-1) == lab_c[idx_tr]).float().mean(),
                    cross_entropy(ev[idx_va], lab_c[idx_va]),
                    (ev[idx_va].argmax(-1) == lab_c[idx_va]).float().mean(),
                ]).cpu()

        epoch()
        kernels.reset_launch_counts()
        epoch()
        torch.cuda.synchronize()
        epoch_launches[fmt] = kernels.launch_counts()
        print(f"[p] cora differential_gcn epoch {fmt}: " + json.dumps(
            dict(profile_call(epoch, f"epoch_cora_{fmt}", root),
                 max_steps=ms_c, launches_per_epoch=epoch_launches[fmt])))

    # one steady lstm_gnn train step on the grid400 Kipf operator (COO):
    # 79 teacher steps, each a K1 launch forward and one over Aᵀ backward
    model_t = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5, 400,
                                10, "lstm", device=dev)
    op_t = as_operator(kipf400, sparse=True, format="coo", device=dev)
    y_t = y_train.to(dev)

    def temporal_loss():
        loss = l1_loss(temporal_gcn_forward(model_t, op_t, y_t[:, :-1],
                                            "lstm"), y_t[:, 1:])
        return loss, loss

    step_t = make_sgd_step(torch_adam(model_t.parameters(), 0.01, 1e-3),
                           temporal_loss)
    step_t()
    kernels.reset_launch_counts()
    step_t()
    torch.cuda.synchronize()
    temporal_launches = kernels.launch_counts()
    print("[p] train lstm_gnn grid400 COO: " + json.dumps(
        dict(profile_call(step_t, "train_lstm_gnn_coo", root),
             launches_per_step=temporal_launches)))

    def per_step(name):
        """The most launches of ``name`` in one steady train step of any
        setting above, and that setting (0 and None for a tool's kernel)."""
        label = max(step_launches, key=lambda k: step_launches[k][name])
        count = step_launches[label][name]
        return {"launches_per_step": count,
                "step_of": label if count else None}

    def per_epoch(name):
        """Launches of ``name`` in one steady cora epoch, by format."""
        return {fmt: c[name] for fmt, c in epoch_launches.items()}

    def citation_cases(cases):
        """[16] a's cases of one kernel: each shape's forward and transpose
        times, bound and library time."""
        keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")
        return {label: dict(n=c["n"], d=c["d"], **{
            part: {k: c[part].get(k) for k in keys}
            for part in ("fwd", "transpose")}) for label, c in cases.items()}

    # ---- records
    def entry(name, src, replaces, fwd, bwd=None, **extra):
        """One kernel's line: its launches on the main paths and in one
        steady train step, and the forward case's error, times and bound
        (and the backward case's, as ``bwd_*``)."""
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms")
        rec = {"name": name, "route": "cuda",
               "source": f"ndcn_tpu_torch/csrc/{src}", "replaces": replaces,
               "launches": main_launches[name], **per_step(name),
               **{k: fwd.get(k) for k in keys}}
        if bwd is not None:
            rec.update({f"bwd_{k}": bwd.get(k) for k in keys})
        return dict(rec, **extra)

    # the sliced-tile reduce reads the gathered slots, their local rows and
    # values, and writes the padded (d_sub, n) result; the row gather reads
    # and writes rows × k floats and reads the indices
    d_sub_mb = coo_spmv.sublane_pad(mb["d"])
    slots = mb["slices"] * mb["E"]
    # the two kernels once more at the tools' sizes (the packing of the
    # tool's own edge list), queued behind a spin kernel: their device time
    rs = np.random.RandomState(0)
    tiles = sparse_bench.pack_sliced_tiles(
        np.sort(rs.randint(0, mb["n"], size=mb["nnz"])).astype(np.int32),
        rs.randint(0, mb["n"], size=mb["nnz"]).astype(np.int32),
        rs.rand(mb["nnz"]).astype(np.float32), mb["n"], device=dev)
    gathered = torch.rand((d_sub_mb, tiles.cols.shape[0]), device=dev)
    x_pr = torch.rand((probe["m"], probe["k"]), device=dev)
    idx_pr = torch.as_tensor(rs.randint(0, probe["m"], probe["rows"])
                             .astype(np.int32), device=dev)
    idx64_pr = idx_pr.long()
    p1a_out = sparse_bench.sliced_tile_reduce(tiles, gathered)
    check(torch.equal(p1a_out, sparse_bench.sliced_tile_reduce(tiles,
                                                                gathered)),
          "P1a: two calls differ")
    check(max_rel(p1a_out, sparse_bench.sliced_tile_reduce_plain(
        tiles, gathered))[1] <= 1e-5, "P1a disagrees with its plain version")
    del p1a_out
    p1a = dict(max_abs_err=mb["sliced_reduce_max_abs_err"],
               rel_err=mb["sliced_reduce_kernel_vs_plain"], repeat_equal=True,
               # the tool's [6]: the minor gather yT[:, slot_cols], then the
               # reduce, kernel and plain
               spmv_e2e_ms=mb["sliced_spmv_kernel_ms"],
               spmv_e2e_plain_ms=mb["sliced_spmv_plain_ms"],
               device_ms=queued_ms(
                   lambda: sparse_bench.sliced_tile_reduce(tiles, gathered)),
               library_device_ms=queued_ms(
                   lambda: sparse_bench.sliced_tile_reduce_plain(tiles,
                                                                 gathered)),
               ms=mb["sliced_reduce_kernel_ms"],
               plain_ms=mb["sliced_reduce_plain_ms"],
               library_ms=mb["sliced_reduce_plain_ms"],
               **bound(slots * (d_sub_mb * 4 + 8)
                       + d_sub_mb * -(-mb["n"] // mb["R"]) * mb["R"] * 4,
                       2 * slots * d_sub_mb))
    p1b = dict(max_abs_err=mb["row_gather_max_abs_err"],
               device_ms=queued_ms(
                   lambda: sparse_bench.row_gather(x_pr, idx_pr)),
               # the launch floor: the spin kernel for 0 cycles, queued alike
               empty_kernel_device_ms=queued_ms(
                   lambda: torch.cuda._sleep(0)),
               library_device_ms=queued_ms(
                   lambda: torch.index_select(x_pr, 0, idx64_pr)),
               ms=probe["kernel_us"] / 1e3, plain_ms=probe["index_us"] / 1e3,
               library_ms=probe["index_select_us"] / 1e3,
               **bound(probe["rows"] * (2 * probe["k"] * 4 + 4), 0))
    K1 = "ndcn_tpu/kernels/coo_spmv.py:159"
    # [23] and [24]: each kernel's launches in one graphed train step, by
    # setting (K1 on [24] c's row block under its own count)
    graphed23 = {k: {**scan23["launches_per_graphed_step"].get(k, {}),
                     **scan24["launches_per_graphed_step"].get(k, {})}
                 for k in ("coo_spmv", "fused_rhs", "bsr_spmm",
                           "bsr_fused_rhs")}
    graphed23["coo_spmv"].update(
        {f"{label} (row block)": v for label, v in scan24[
            "launches_per_graphed_step"].get("coo_spmv_rowblock", {}).items()})
    mark_phase("end")
    print("[t] phase seconds: " + json.dumps(clock["seconds"]))
    print(json.dumps({"kernels": [
        entry("coo_spmv", "coo_spmv.cu", K1, k1_main, k1t,
              launches_in_artifact=artifact_launches["coo_spmv"],
              launches_per_graphed_step=graphed23["coo_spmv"],
              citation=citation_cases(k1_cite),
              launches_per_cora_epoch=per_epoch("coo_spmv"),
              temporal=citation_cases(k1_temporal),
              launches_per_temporal_step=temporal_launches["coo_spmv"]),
        entry("fused_rhs", "fused_rhs.cu", "ndcn_tpu/kernels/fused_rhs.py:30",
              k2_main, k2b,
              launches_in_artifact=artifact_launches["fused_rhs"],
              launches_per_graphed_step=graphed23["fused_rhs"]),
        entry("bsr_spmm", "bsr_spmm.cu", "ndcn_tpu/kernels/bsr_spmm.py:91",
              k3["grid400_d20"]["fwd"], k3["grid400_d20"]["transpose"],
              launches_in_artifact=artifact_launches["bsr_spmm"],
              launches_per_graphed_step=graphed23["bsr_spmm"],
              citation=citation_cases(k3_cite),
              launches_per_cora_epoch=per_epoch("bsr_spmm"),
              temporal=citation_cases(k3_temporal),
              launches_per_temporal_step=steps17["lstm_bsr"][
                  "sparse_launches"]["bsr_spmm"]),
        entry("bsr_fused_rhs", "bsr_spmm.cu",
              "ndcn_tpu/kernels/bsr_spmm.py:176", k4["grid400_d20"]["fwd"],
              k4["grid400_d20"]["bwd"],
              launches_in_artifact=artifact_launches["bsr_fused_rhs"],
              launches_per_graphed_step=graphed23["bsr_fused_rhs"]),
        # the replica sweeps' batched forms (R states against one operator
        # in one launch): the grid400 d = 20 case at R = 16, R = 1 beside
        entry("coo_spmv_batched", "coo_spmv.cu", K1,
              kb["k1"]["grid400_d20_r16"], r1=kb["k1"]["grid400_d20_r1"],
              citation_r25=kb["k1"]["cora_d16_r25"],
              launches_per_replica_step=sweep18["coo"]["launches_r16"][
                  "ours"].get(
                  "coo_spmv_batched", 0)),
        entry("fused_rhs_batched", "fused_rhs.cu",
              "ndcn_tpu/kernels/fused_rhs.py:30",
              kb["k2"]["grid400_d20_r16"], r1=kb["k2"]["grid400_d20_r1"],
              launches_per_replica_step=sweep18["dense"]["launches_r16"][
                  "ours"].get(
                  "fused_rhs_batched", 0)),
        entry("bsr_spmm_batched", "bsr_spmm.cu",
              "ndcn_tpu/kernels/bsr_spmm.py:91",
              kb["k3"]["grid400_d20_r16"], r1=kb["k3"]["grid400_d20_r1"],
              citation_r25=kb["k3"]["cora_d16_r25"],
              launches_per_replica_step=sweep18["bsr"]["launches_r16"][
                  "ours"].get("bsr_spmm_batched", 0)),
        # K1's wide form (rows wider than a warp's 32 loads): cora at
        # d = 1433, forward and over the transpose; citeseer at 3703, bf16,
        # 2 row blocks, batched at R = 25 beside
        entry("coo_spmv_wide", "coo_spmv.cu", K1, k1_cite["cora_d1433"]["fwd"],
              k1_cite["cora_d1433"]["transpose"],
              citeseer_d3703=k1_cite["citeseer_d3703"],
              bf16=k1_cite["cora_d1433"]["bf16"],
              row_blocks_2=k1_cite["cora_d1433"]["row_blocks_2"],
              batched_r25=kb["k1"]["cora_d1433_r25"],
              batched_launches=main_launches["coo_spmv_wide_batched"]),
        # K3's batched form in replica groups: cora d = 16 at R = 25,
        # forward and over Aᵀ; grid400 d = 20 at R = 16 beside
        entry("bsr_spmm_grouped_batched", "bsr_spmm.cu",
              "ndcn_tpu/kernels/bsr_spmm.py:91", kb["k3"]["cora_d16_r25"],
              kb["k3"]["cora_d16_r25_transpose"],
              grid400_r16=kb["k3"]["grid400_d20_r16"],
              launches_per_replica_step=sweep18["bsr"]["launches_r16"][
                  "ours"].get("bsr_spmm_grouped_batched", 0)),
        entry("bsr_fused_rhs_batched", "bsr_spmm.cu",
              "ndcn_tpu/kernels/bsr_spmm.py:176",
              kb["k4"]["grid400_d20_r16"], r1=kb["k4"]["grid400_d20_r1"],
              launches_per_replica_step=sweep18["bsr"]["launches_r16"][
                  "ours"].get("bsr_fused_rhs_batched", 0)),
        entry("coo_spmv_bf16", "coo_spmv.cu",
              "ndcn_tpu/kernels/coo_spmv.py:172",
              k11["k1_bf16_200k"]["fwd"], k11["k1_bf16_200k"]["transpose"]),
        # the Pallas kernel at :159, reached through _spmv_T (:322)
        entry("coo_spmv_T", "coo_spmv_T.cu", K1, k11["k1fm_f32_1m"]["fwd"],
              k11["k1fm_f32_1m"]["transpose"],
              reached_through="ndcn_tpu/kernels/coo_spmv.py:322",
              launches_in_artifact=artifact_launches["coo_spmv_T"]),
        entry("coo_spmv_T_pack", "coo_spmv_T.cu", K1, k11["pack_f32_1m"],
              reached_through="ndcn_tpu/kernels/coo_spmv.py:322",
              launches_in_artifact=artifact_launches["coo_spmv_T_pack"]),
        entry("coo_spmv_T_wide", "coo_spmv_T.cu",
              "ndcn_tpu/kernels/coo_spmv.py:207", k11["k5_f32_1m"]["fwd"],
              k11["k5_f32_1m"]["transpose"],
              launches_in_artifact=artifact_launches["coo_spmv_T_wide"]),
        # the Pallas kernel at coo_spmv.py:314, driven with per-edge weights
        # by the mutualistic interaction: at d = 1 its edge form (the warp
        # form, coo_mutual.cu, takes d > 8); launches of either form, and
        # of the edge form alone
        entry("coo_mutual", "coo_mutual_edges.cu",
              "ndcn_tpu/dynamics/rhs.py:109",
              k1w["50k_d1"]["fwd"], k1w["50k_d1"]["bwd"],
              pallas_site="ndcn_tpu/kernels/coo_spmv.py:314",
              edge_form_launches=main_launches["coo_mutual_edges"],
              warp_form_source="ndcn_tpu_torch/csrc/coo_mutual.cu",
              launches_per_ground_truth=c_mut["coo_mutual"]),
        # K1 and K1-fm's gather on each rank's row block (the mesh path,
        # [19]): the 200k operator's 4 blocks, times summed over them
        entry("coo_spmv_rowblock", "coo_spmv.cu",
              "ndcn_tpu/parallel/coo_shard.py:134", k19["k1_f32"]["fwd"],
              k19["k1_f32"]["transpose"], pallas_site=K1,
              bf16=k19["k1_bf16"], batched_r4=k19["k1_batched_r4"],
              launches_per_mesh_step=per_step19["coo_spmv_rowblock"],
              launches_per_model_axis_step={
                  k: v.get("coo_spmv_rowblock", 0)
                  for k, v in per_step22.items()}),
        entry("coo_spmv_T_rowblock", "coo_spmv_T.cu",
              "ndcn_tpu/parallel/coo_shard.py:165", k19["k1fm_f32"]["fwd"],
              k19["k1fm_f32"]["transpose"],
              reached_through="ndcn_tpu/kernels/coo_spmv.py:322",
              bf16=k19["k1fm_bf16"]),
        entry("sliced_tile_reduce", "sparse_bench.cu",
              "tools/microbench_sparse.py:235", p1a,
              spmv_e2e_ms=p1a["spmv_e2e_ms"],
              spmv_e2e_plain_ms=p1a["spmv_e2e_plain_ms"]),
        entry("row_gather", "sparse_bench.cu",
              "tools/microbench_sparse.py:288", p1b,
              also_replaces="tools/probe_inkernel_gather.py:60",
              empty_kernel_device_ms=p1b["empty_kernel_device_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        side_main(sys.argv[2], sys.argv[3])
    else:
        main()
