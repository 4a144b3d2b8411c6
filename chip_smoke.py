#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wave_fenics_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (numbered in the order they were added; 12 and 13 run after 6, 14
and 17 after 8, 15 inside 11, after P9, on the P8 model, 16 inside 10, 18
inside 15, after P18, 19 after 17, 20 inside 11); any failure raises, so
the script exits non-zero and never prints its last line:

1. device: a CUDA card, its name and power limit (nvidia-smi), TF32 off
   for the plain versions;
2. build: nvcc compiles csrc/*.cu for sm_90a (ops/_cuda.py);
3. kernel B (stiffness/m on the flat layout, csrc/flat_tiled.cu) against
   its plain version and its plain twin in the kernel's sum order: f64 at
   every p = 1..8 on (4,2,2) and (5,3,3) cells, limit 1e-12 relative; f32
   at the headline size (64x32x32 cells, p=4, tile 48: the P1 layout),
   limit 1e-5 of max|ref|; each from an output full of NaN, the padding
   then exactly 0; with its time against the bound;
4. kernel A (lean RK4 step, csrc/rk4_tiled.cu) against the plain lean
   step: f64 at (4,2,2) cells for p in {1, 2, 3, 4} and at p=4 on (9,4,8)
   cells, whose 37x17x33 interior is no multiple of the tiling's CX, TY
   or TZ, 25 steps, limit 1e-12 relative; f32 at the headline size, 50
   steps, limit 1e-4; each run from output and scratch buffers full of
   NaN, then the padding exactly 0 and no NaN; with the time of each
   stage launch and of a step against the bound and the 4-launch floor;
5. kernels C (full-tableau RK4 step), D (fused RK4 stage, csrc/
   rk_stage_tiled.cu), H (leapfrog step) and I (two leapfrog steps; both
   csrc/lf_tiled.cu) against their plain versions, each through its model
   solver: f64 at (4,2,2) cells, tile 16, p in {2, 4} (and 8 for D; H and
   I at every p = 1..8, tile 24 where I's 3p halo needs it), 25 steps,
   limit 1e-12 relative (C also against kernel A, 1e-13); f32 at the full
   width of its app path, 50 steps, limit 1e-4 relative; C, H and I from
   NaN-filled kernel buffers, whose padding then holds exactly 0; with
   times per kernel call at that width (kernel D on six distinct state
   fields, as stages 1-3 of the path give it; H and I phase by phase). Kernel D also one stage in f64 on
   (5,3,3) cells, p in {2, 4, 8}, from inputs random in the padding and
   outputs full of NaN, out of place and with ua/va in place: limit 1e-12
   relative, kv' exactly 0 and va' exactly va in the padding; its f32
   run from NaN-filled buffers.
   Every check of phases 4 and 5 starts from a random state with zero
   padding, so the absorbing row carries O(max|v|) values; the relative
   error is the larger of |du|/max|u_ref| and |dv|/max|v_ref|; kernel C,
   like A, runs from NaN-filled buffers and is timed stage by stage;
6. kernels F (the separable stiffness on the unpadded grid, csrc/
   stiffness_tiled.cu) and G (the BP1 consistent mass on the padded
   layout, csrc/mass_tiled.cu) against their plain versions: f64 small
   (F: (4,2,3) and (5,3,4) cells at every p = 1..10, Nx = 17 at p=4; G:
   (3,2,2) and (5,3,4) cells at every p = 1..8, also against the plain
   twin in G's z, y, x order; each from an output full of NaN), limit
   1e-12 relative; f32 at the reference's BP1 size (64^3 cells, p=4,
   16,974,593 dofs), limit 1e-5 of max|ref|, from NaN, G's padding then
   exactly 0; with times against each bound, and G
   beside the one PyTorch call that computes its function (torch.einsum
   of the three assembled 1D mass matrices, dense, with the grid; TF32
   off), which must agree to 1e-5 of max|ref|;
7. physics: the f64 analytic plane wave (16x2x2 cells, 6 mm) through
   solve_step_n on kernel A; the leapfrog's 2nd order through kernel H
   (f64, (4,2,2), p=4: the error against a fine RK4 reference shrinks
   2.8-5.5x when dt halves); an odd step count through solve_lf2_n
   launches kernel H for the last step; LinearWave.solve on the card (the
   unpadded eager model, kernel F in f1: f64 (4,2,2), p=4, 25 steps)
   against solve_step_n (kernel A), limit 1e-12 relative;
8. the app paths at 4,276,737 dofs, through ``planar3d_app.run`` with the
   full step counts: P1 RK4 (kernel A, p=4), P2 leapfrog (kernel I, p=4),
   P3 leapfrog (kernel H, p=8), P4 RK4 (kernel D, p=8), P5 RK4 with the
   full tableau (kernel C, p=4). Every launch count is set to 0 just before
   each run and read just after it; each path must have launched its
   kernels once per kernel launch of (its steps + one warm-up call) and no
   other kernel. Then kernel B's own path, the f1-path RK4
   (PaddedLinearWave.solve_n), for two steps against the step path, with
   its own count; then a two-point rate of solve_step_n;
9. the operator benchmark paths at 16,974,593 dofs (64^3 cells, p=4, f32),
   each with its own counts: P6 ``cg_bench.run`` BP1 (kmax 50, rtol 1e-4):
   kernel G launched solves x (1 + iterations) times and no other kernel;
   then CG on kernel G against CG on the plain matvec from the same b
   (iterations within 1, solutions within 1e-3 relative); P7
   ``operators_bench.run`` stiffness (kernel F) and bp1-mass (kernel G)
   with ``check``: one launch per apply, error against the f64 oracle
   within 1e-5;
10. kernel K (the explicit-dofmap matvec) against its plain version:
    f64 on small perturbed meshes ((5,4,3) cells at p <= 2, (4,3,3) at
    p = 4, (2,2,2) at p = 6), every mode (collocated mass and stiffness at
    p in {1, 2, 4, 6}, mass_gauss and stiffness_gauss at p in {1, 2, 4}),
    limit 1e-12 relative, and the affine (rank-1) geometry on a box; f32 at
    the P8 size (the perturbed 64x32x32-cell box, p=4, 4,276,737 dofs; the
    model built once, its host setup seconds printed) in the stiffness and
    mass modes, limit 1e-5 of max|ref|; two applies bitwise equal; with
    times against the bound (back-to-back applies: y = 0 and one launch
    per colour, the colours overlapping);
11. the general-mesh paths, each counted alone: P8 ``general_solve.run``
    RK4 (200 steps) and P9 leapfrog on that model: kernel K launched
    solves x applies per solve (4 per RK4 step; one per leapfrog step and
    one at t0) and no other kernel, |v| finite and below 1e15; P10
    ``operators_bench.run`` at s=16 (box) for stiffness-general (affine),
    mass-general, stiffness-gauss and mass with ``check``: one launch per
    apply, error against the f64 oracle within 1e-5; P11 ``cg_bench.run``
    general (the Gauss mass, Jacobi): kernel K launched solves x (1 +
    iterations) times; then the assembled CSR SpMV (``torch.sparse.mm``)
    against kernel K's stiffness on the perturbed 16^3-cell box (274,625
    dofs), both times;
12. kernel E (the 3D-slab stiffness/m, p > 8 or kernel='3d'; csrc/
    slab_tiled.cu) against its plain version: f64 at every p = 1..10 on
    (3,2,3) cells with kernel='3d', at p in {9, 10} on small grids and at
    p = 4 on (4,2,2), limit 1e-12 relative; f32, one apply at the P12 size
    (planar3d p = 10, 26x13x13 cells, 4,479,021 dofs, padded (304, 152,
    256)), limit 1e-5 of max|ref|; each from an output buffer full of NaN,
    the padding then exactly 0; with its time against the bound;
13. kernel J (two full-tableau RK4 steps, 7 launches; its step boundary
    csrc/rk42_tiled.cu) against its plain version (f64, (4,2,2) cells,
    tile 24 or the 6p halo above it, every p = 1..8, 25 steps from NaN in
    every kernel buffer, the odd last step on kernel C; limit 1e-12
    relative) and against kernel C's steps (1e-13); the step boundary
    alone against its plain version (f64 at p in {2, 4, 8}, 1e-12 per
    field; f32 at the P1 width on the stages of a J call, 1e-5), from
    outputs full of NaN, their padding exactly 0; f32 at the P1 width, 50
    steps, limit 1e-4; with its time per two steps against two kernel-C
    steps and the bound, and the boundary launch's time against its own
    bound (8 state fields);
14. the new app paths, each counted alone (warm-up call included): P12 RK4
    p = 10 on kernel E (4 x (3,762 + 1) launches), P13 leapfrog p = 10 on
    kernel E ((5,299 + 1) + 2), P14 ``--two-step`` at the P1 configuration
    (kernel J 7 x (744 + 1) = 5,215, its step boundary 745 of them, kernel
    A 4 for the odd last step), and
    P15: the P1 configuration through ``--config`` and ``--checkpoint-dir``,
    300 steps in chunks of 100, snapshots at steps 100 and 200, then a
    second call that resumes from step 200; each call's final state within
    1e-5 relative of one unchunked 300-step run;
15. the imported-mesh workflow, each path counted alone: P16 the P8 model
    (the perturbed 64x32x32-cell box, p=4, f32) written as binary XDMF
    (mesh and facet meshtags) and run through ``planar3d_app.run`` with
    ``mesh_path``, ``meshtags_path`` and ``output_path`` at the full step
    count: kernel K 4 x (steps + 1 warm-up step) applies and no other
    kernel, |v| finite and below 1e15, the output's points the dof
    coordinates and its u, v the returned state exactly; P17 the same with
    leapfrog, 400 steps in chunks of 100 (K: 400 + 4 chunk starts + 2 for
    the warm-up step), within 1e-5 relative of one unchunked solve; P18
    the box branch's ``--output`` at the P1 configuration, 100 steps on
    kernel A, the fields ``to_grid`` of the state and the node lines
    ``StructuredDofGrid``'s exactly; P19 ``general_wave.solve_recording``
    on the P8 model (200 RK4 steps, 3 probes: K 800 applies, the final
    state bitwise equal to ``solve_n``'s, the last row u at the probes),
    ``linear_wave.solve_recording`` on kernel F (f64, (16,8,8) cells, p=4,
    25 steps) against the CPU, and ``diagnostics.energy`` on F and K (f64)
    against the CPU, limit 1e-12 relative;
16. the general-model set-up on the card (``native``: csrc/setup_kernels.cu,
    run before phase 10's f32 checks, and on P16's mesh inside 15): the P8
    model built on the card (one launch each of the geometry and node-key
    kernels, one dedup for the dofmap and one a tag), a second build bitwise
    equal (dofmap, dof coordinates, G, detJw, m, W1, W2), and the NumPy route
    built once at full size as the oracle: ndofs, the dofmap and the affine
    flag equal, dof coordinates within 1e-15 relative, m, W1 and W2 (f32)
    within 1e-6; G (f64) within 1e-13 of max|G| and detJw within 1e-13
    relative of the NumPy route's (whose own J loses |X| / h ulps), the
    card's detJw within 1e-15 of an 80-bit J on 4,096 cells, no clamp
    decision that differs; a degenerate cell raises; both routes' set-up
    seconds; each set-up kernel against its plain version at the P8 shapes
    (the node keys and the dedup bit for bit) and timed against its bound,
    the dedup beside ``torch.unique(dim=0)``. P16's mesh read back from XDMF
    and built on the card: the NumPy route's dofmap, m, W1 and W2, and the
    P8 model's G, m, W1 and W2 bit for bit. P10, P11, P16 and P17 check
    their set-up launches.

17. the distributed structured box (``parallel/``, P20; every block on
    this card, so the numbers are the one-card cost of the exchange and of
    the per-block launches, not scaling): f64 at (8,4,4) cells, p=4, 12
    steps, each sharded path against the one-device solve of the same path
    (the value-halo step on A, leapfrog on H and I at (2,2,1); the
    per-stage halo-add on B at (2,2,1) and on E at (2,1,1);
    ``ShardedLinearWave`` on F), limit 1e-12 relative, the shared interface
    planes bitwise equal (after a refresh on the value-halo paths); one call
    of A, H and I on each block of their value-halo layouts (halo 3p, 2p,
    3p) at the P1 width, (2,2,1), f32, from output and scratch buffers full
    of NaN: the interior against the plain version within 1e-5, the outputs
    exactly 0 outside their ring, no NaN; at the P1 width (f32, tile 48,
    100 steps) ``solve_step_n`` at (2,1,1) and (2,2,1), ``solve_lf_n`` and
    ``solve_lf2_n`` at (2,2,1), ``solve_n`` (B) at (2,1,1), and at P12's
    p = 10 ``solve_n`` on E at (2,1,1) for 20 steps: B and E first called
    on each block at its shape and on its tables, from NaN, against their
    plain versions within 1e-5 (the padding exactly 0), then each kernel
    launched once per block per launch of a step and no other, the global
    grid within 1e-4 of the one-device solve, the interface planes bitwise
    equal; ms/step beside the one-device path's, the exchange's share of a
    step (CUDA events around every slab swap inside the timed solve: the
    value-halo refresh, or the halo-add's copies) and the launches per
    step; ``ShardedLinearWave`` (F) at (2,2,1), F on each block against its
    plain version within 1e-5, then 10 steps within 1e-4 of
    ``LinearWave``, with its exchange share; and the app's ``--ndev 4`` at the P1 configuration, RK4
    (A: 4 x (1,489 + 1) x 4 launches) and leapfrog (H: 2 x (2,098 + 1) x 4),
    with the JAX app's ``solver_path`` strings, |u| within 1e-4 of P1's and
    P2's;
18. the distributed imported mesh (``parallel/sharded_general.py``, P21):
    P16's mesh (the perturbed 64x32x32-cell box, p=4, f32, 4,276,737 dofs)
    on 4 RCB parts, all on this card (so the numbers are the one-card cost
    of the assembly and of the per-part launches, not scaling): the host
    set-up's seconds and the parts' cells, dofs, interface slots, colours
    and rounds; kernel K on each part's own tables from an output full of
    NaN against its plain version within 1e-5 of max|ref|, two applies
    bitwise equal, its time against the bound at the part's bytes; 100
    RK4 steps with ``allgather`` and with ``ppermute`` and 100 leapfrog
    steps with ``auto``, each K launch counted (4 parts x 4 x 100; 4 x
    101), within 1e-4 of ``GeneralLinearWave.solve_n`` on the card, the two
    modes within 1e-6 of each other, ms/step beside one device's, the
    assembly's share of a step (CUDA events around every assembly inside
    the timed solve) and the idle share (the profiler over 20 steps); f64 on
    the 6x4x4 perturbed box, p=4, 8 parts, within 1e-12 of one device; the
    app's ``--mesh --ndev 4``, RK4 to tf (K 4 x 4 x (steps + 1)) with |u|
    within 1e-4 of P16's, and leapfrog 400 steps in chunks of 100, then
    again from the snapshot of step 200 (K 4 x (400 + 4 + 2), 4 x (200 + 2
    + 2)), each within 1e-5 of one unchunked 4-part solve, which is within
    1e-4 of one device's;
    ``cg_bench.run(op="general", s=16, degree=4, ndev=4)``, iterations
    within 1 of one device's; ``scatter_bench`` local and halo at size 64,
    general-halo at size 32 with both modes, launching no kernel;
19. the distributed 2-step RK4 (kernel J on the 6p value halo), Newmark and
    heterogeneous media: inside phase 17, f64 at (8,4,4) cells on (2,2,1)
    ``solve_step2_n`` from a random O(1) state, 12 steps, against one
    device's ``solve_step_n``, limit 1e-12; one call of J's seven launches on
    each block of the 6p layout at the P1 width, (2,2,1), f32, from NaN,
    against its plain version on the whole state (the plain version computes
    the same launch boxes, ``ops.rk42step.call_rings``), limit 1e-5, and the
    step boundary's time on block 0's grown box; P22, ``solve_step2_n`` at
    the P1 width on (2,1,1) and (2,2,1), f32, 100 steps, checked like P20's
    runs (7 J launches per block per 2 steps, within 1e-4 of one device's
    J), with its device ms/step and idle share (the profiler over 20 steps)
    beside one device's J and the sharded step A; P23, ``newmark_solve_n``
    at the P1 size, f64, 30 steps of 10x the RK4 step: CG iterations a step,
    ms/step, kernel F launched once per right-hand side, once per CG matvec
    and once for the initial acceleration and no other kernel, the host
    syncs a step, a finite state with max|u| within twice RK4's at its own
    step over the same time; P24, ``LinearWave(c0_cells)`` (f64 (4,2,2)
    two layers on the card against the CPU, limit 1e-12; then two layers,
    1.3 c0 and c0 across x = L/2, at the P1 size, f32, 100 RK4 steps on the
    per-cell path, no kernel launched, the field off the homogeneous
    model's by more than 1e-3 of max|u|): ms/step;
20. ``EAOperator`` at 16^3 cells, p=4 (the perturbed box, f32): against
    kernel K within 1e-5 of max|ref|, ms/apply beside K and the CSR SpMV;
21. ``benchmarks/tsmm.py`` at the JAX defaults (100,000 cells, p=4, f32):
    TF32 off (its flags read back), f32 against f64 on the first 1,000
    cells within 1e-5 of max|ref|, no hand kernel launched; ms/apply,
    GFLOP/s on both flop models, the bound (one pass of u and y) and each
    of the six contractions alone;
22. the dry run (``apps/dryrun.py``) at 8 blocks, f32, 2 cells a block on
    each axis: every check of the JAX dry run at its tolerances, the 2-step
    RK4 included, and kernels A, B, F, H, I, J and K launched and no other;
23. the four examples at their JAX sizes, each counted alone and asserting
    what its JAX counterpart asserts: the convergence study (F), the f64
    plane wave to < 1e-6 (F, 4 a step), ``multichip_solve 8`` (B, 8 blocks
    x 4 x 10 steps) and ``unstructured_distributed_solve 8`` (K, (8 parts +
    one device) x 4 x 10, within 1e-12 of one device);
24. bf16 state (``bf16_phase``): (a) kernels A (on (4,2,2) cells at p in
    {2, 4} and on (9,4,8) at p=4), C (p in {2, 4}), D (p in {4, 8}), B
    and F (p in {2, 4}) against their plain bf16 twins on the CPU, from
    NaN-filled outputs and scratch: one step, stage or apply within 1e-2
    of max|ref| with the padding exactly 0, and a 25-step solve (A, C, B,
    D through their model solvers, F through ``LinearWave.solve``) within
    1.5x the plain bf16 run's own error against the plain f64 run from the
    same state; (b) the app's ``--dtype bf16`` at the P1 configuration,
    RK4 on kernel A for the whole solve (4 x (1,489 + 1) launches and no
    other kernel), finite, max|u| at least half the f32 run's (the source
    switched on; with bf16 tables the scheme grows at this width, so no
    upper bound), its relative L2 against f32 printed, and kernel A's path
    against the plain twin's over 200 steps at that width within 1e-2;
    then max|A 1| (kernel B on a constant field) in bf16 and f32 and max|u|
    of both along the solve, which show where that growth comes from;
    (c) A and C (each stage and the step, beside the 4-launch floor), B
    (the P1 layout), D (the P4 layout) and F (64^3 cells, p=4) in bf16
    beside f32 in this call, against the bound at 2 bytes a value;
25. bf16 state on the leapfrog, two-step and p > 8 paths
    (``bf16_paths_phase``): (a) kernels H and I (p in {1, 3, 4, 8}), J and
    its step boundary (p in {1, 3, 4}) and E (p in {9, 10}, and
    kernel='3d' at p=4) against their plain bf16 twins on the CPU, on
    small grids of several y and z tiles, from NaN-filled outputs and
    scratch: one call within 1e-2 of max|ref|, the padding exactly 0; (b)
    the app's ``--dtype bf16`` at full width for the whole solve: P2
    leapfrog (I, 3 x (2,098/2 + 1)), P3 p=8 leapfrog (H, 2 x (4,134 + 1)),
    P14 ``--two-step`` (J 7 x (1,489 // 2 + 1), A 4 for the odd step), P12
    p=10 RK4 (E 4 x (3,762 + 1)) and P13 p=10 leapfrog (E (5,299 + 1) + 2),
    each counted alone, only its kernels, finite, max|u| at least half the
    f32 run's (phases 8 and 14 keep their final states), the relative L2
    against f32 and max|u| over f32's printed; then each path against its
    plain twin's over 25 steps at that width within 1e-2; (c) E (P12), H
    (P3) and I (P2) phase by phase and J's step boundary (P1 width) in
    bf16 beside f32 in this call, against the bound at 2 bytes a value,
    each bf16 kernel's output from NaN against its plain twin's.

26. bf16 state on kernels G and K, the imported mesh, the sharded paths
    and the benchmarks (``bf16_rest_phase``): (a) G (p in {1, 2, 4, 8} on
    two small grids, and at P7's grid) and K (collocated p in {2, 4, 6},
    Gauss p in {2, 4}, affine cells; at P8 in its four modes) against
    their plain bf16 twins from NaN-filled outputs: one apply within 1e-2
    of max|ref|, G's padding exactly 0, two K applies bitwise equal; (b) G
    at P7 and K's four modes at P8 in bf16 beside f32 in this call, against
    the bound at 2 bytes a value, with G's bf16 ``torch.einsum`` of the
    assembled 1D masses and K's bf16 CSR ``torch.sparse.mm`` at 16^3 cells
    (or "not in torch"); (c) the app's ``--dtype bf16`` to tf on its
    kernels only, each counted alone: P16 (``--mesh``), P20's ``--ndev 4``
    RK4 and leapfrog and P21's ``--mesh --ndev 4``, max|u| over f32's
    printed; each path against its twin over 25 steps (P16 against the
    plain K twin, 1e-2; the value-halo blocks against one device bit for
    bit; the parts against one device, 2e-2); (d)
    ``cg_bench`` BP1 at P6 and ``--op general``, ``operators_bench``
    bp1-mass and K's four ops with ``--check``, ``general_solve`` at P8,
    ``scatter_bench``'s three modes and ``tsmm``, each with ``--dtype
    bf16``, their JSON lines printed (``bench26 ...``).
27. ``benchmarks/suite.py --quick`` (``suite_phase``) through its ``main``
    on the card, its document under a temporary directory, counted alone:
    0 errors, one record an entry, every record's ``device`` the card, the
    three headline records (``padded`` on B, ``fused`` on D, ``step`` on A
    at 32x16x16 cells, p=4, 50 steps), 0 < the summary's
    ``headline_pct_of_measured_ceiling`` <= 100 (the step record's), the
    streaming ceiling (``common.stream_ceiling_gbps``) within 1,500-3,350
    GB/s, and kernels A, B, D, F, G and K launched and no other (A, B and
    D 4 x 236 times each: the warm-up call, three windows of 50 steps and
    three of 12); the suite's seconds, each headline record and the
    ceiling printed (``suite {...}``: the summary). Then kernels B (the P1
    layout), E (P12) and F (257^3 grid) beside ``torch.sparse.mm`` of their
    operator assembled as a CSR matrix with int32 indices
    (``apps/kernel_times.py::library_times``; within 1e-5 of max|kernel|):
    their ``library_ms``.

It prints one JSON line of per-kernel results ("kernels": all eleven
kernels, each with the launches of its path's run, J's step boundary
alone, and the three set-up kernels with P16's launches; kernel B's path
is the f1-path RK4 check; K's and F's include phase 15's; A, B, E, F, H,
I and J add phase 17's sharded runs (J: P22) and K phase 18's, listed
under ``sharded_launches``; A, B, F, H, I, J and K add phase 22's dry run
(``dryrun_launches``) and B, F and K phase 23's examples
(``example_launches``); A to F and H to J list phases 24 and 25's
launches (``bf16_launches``), bf16 times (``bf16``; J's: its step
boundary) and their bf16 app runs (``bf16_app``), and G and K phase 26's
(with ``bf16_bench``, the benchmarks' bf16 records); A, B, D, F, G and K
add phase 27's quick suite (``suite_launches``); F adds P23's Newmark
launches; K's entry also lists P21's parts, J's the boundary's time on a
grown box), the lines ``tsmm {...}``, ``dryrun {...}`` and ``bf16 {...}``
(phases 24 to 26's checks), the ``bench26 ...`` lines, and, last, one JSON line ``{"ok": true, "device":
{...}}``. Without a CUDA card, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = dict(cells=(64, 32, 32), degree=4)
HEADLINE_P8 = dict(cells=(32, 16, 16), degree=8)  # the same 4,276,737 dofs
NDOFS = 4_276_737
P12 = dict(cells=(26, 13, 13), degree=10)  # the 3D-slab layout, kernel E
P12_DOFS = 4_479_021
BP1 = dict(size=64, degree=4)  # the reference's documented BP1 size
BP1_DOFS = 16_974_593
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # f32 outside the tensor cores (the same sheet)
F64_FLOPS_PER_S = 34e12    # f64 outside the tensor cores (the same sheet)
RK_A = (0.0, 0.5, 0.5, 1.0)
RK_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
RK_C = (0.0, 0.5, 0.5, 1.0)


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def setup_phase(gmodel, gsetup: float, smi: str, dev) -> dict:
    """Phase 16: the general-model set-up on the card (``native``'s kernels)
    against the NumPy route, at the P8 size. ``gmodel`` is the P8 model that
    ``general_solve.build`` made on the card in ``gsetup`` seconds. Returns
    the NumPy route's results that phase 15 holds P16's mesh against, and
    each set-up kernel's (max_abs_err, ms, plain_ms, (bound_ms, bound_by),
    library_ms)."""
    import numpy as np
    import torch

    from wave_fenics_tpu_torch import native
    from wave_fenics_tpu_torch.benchmarks import general_solve
    from wave_fenics_tpu_torch.core import geometry
    from wave_fenics_tpu_torch.core.basis import clamp_table, tabulate_1d
    from wave_fenics_tpu_torch.core.dofmap import build_dofmap, node_phi
    from wave_fenics_tpu_torch.core.mesh import HexMesh
    from wave_fenics_tpu_torch.models.general_wave import facet_lumped_weights
    from wave_fenics_tpu_torch.ops import _cuda
    from wave_fenics_tpu_torch.ops.operators import GeneralOperators
    from wave_fenics_tpu_torch.utils.timing import timeit

    def rel(a, b):
        a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
        return float((a.cpu() - b.cpu()).abs().max() / b.abs().max())

    def decisions(G):
        return torch.stack([(G - v).abs() <= 1e-8 + 1e-5 * abs(v)
                            for v in (-1.0, 0.0, 1.0)]).any(0)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_FLOPS_PER_S
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    hm, tags = gmodel.mesh, gmodel.facet_tags
    # a second build on the card: bitwise the first (no float atomics)
    g2, gsetup2 = general_solve.build(HEADLINE["cells"], degree=4, dtype="f32")
    same = {
        "dofmap": np.array_equal(gmodel.dofs.dofmap, g2.dofs.dofmap),
        "dof_coords": np.array_equal(gmodel.dofs.dof_coords, g2.dofs.dof_coords),
        "G": torch.equal(gmodel.ops._G, g2.ops._G),
        "detJw": torch.equal(gmodel.ops._detJw, g2.ops._detJw),
        **{k: torch.equal(getattr(gmodel, k), getattr(g2, k)) for k in ("m", "W1", "W2")}}
    print(f"second card build {gsetup2:.3f} s; bitwise equal to the first: {same}")
    check(all(same.values()), f"two card set-ups bitwise equal: {same}")
    del g2

    # the NumPy route, once at full size: the oracle
    t0 = time.perf_counter()
    hm_np, tags_np = general_solve.perturbed_box(HEADLINE["cells"], h=0.002)
    dofs_np = build_dofmap(hm_np, 4)
    ops_np = GeneralOperators(hm_np, dofs_np, dtype=torch.float32)
    m_np = ops_np.lumped_mass
    W_np = {tag: facet_lumped_weights(hm_np, dofs_np, tags_np[tag], 4) for tag in (1, 2)}
    np_setup = time.perf_counter() - t0
    check(np.array_equal(hm_np.points, hm.points) and np.array_equal(hm_np.cells, hm.cells),
          "the NumPy route's mesh is the card's")
    print(f"P8 set-up: card route {gsetup:.3f} s (second build {gsetup2:.3f} s), NumPy "
          f"route {np_setup:.2f} s [{smi}]")
    res = {"ndofs": dofs_np.ndofs == gmodel.ndofs,
           "dofmap": np.array_equal(dofs_np.dofmap, gmodel.dofs.dofmap),
           "affine": ops_np.affine == gmodel.ops.affine}
    coords_rel = rel(gmodel.dofs.dof_coords, dofs_np.dof_coords)
    m_rel = rel(gmodel.m, m_np)
    w_rel = {t: rel(getattr(gmodel, f"W{t}"), W_np[t].astype(np.float32)) for t in (1, 2)}
    print(f"card against NumPy: {res}; dof coordinates {coords_rel:.3e} (limit 1e-15), "
          f"m {m_rel:.3e}, W1 {w_rel[1]:.3e}, W2 {w_rel[2]:.3e} (f32, limit 1e-6)")
    check(all(res.values()), f"card set-up against NumPy: {res}")
    check(coords_rel <= 1e-15 and m_rel <= 1e-6 and max(w_rel.values()) <= 1e-6,
          "card set-up's coordinates, m, W1, W2 against NumPy")
    del ops_np

    # G and detJw in f64 on both routes, unclamped and clamped
    Gn_raw, dwn = geometry.precompute_geometric_data(hm, 4, clamp=False)
    Gn = clamp_table(Gn_raw)
    Gc_raw, dwc = geometry.precompute_geometric_data(hm, 4, clamp=False, device=dev)
    Gc, _ = geometry.precompute_geometric_data(hm, 4, device=dev)
    g_rel, dw_rel = rel(Gc, Gn), rel(dwc, dwn)
    mismatch = int((decisions(Gc_raw).cpu() != decisions(torch.as_tensor(Gn_raw))).sum())
    snapped = int(decisions(Gc_raw).sum())
    # each route's detJw against an 80-bit extended-precision J on a sample
    # of cells (the first and last 2048)
    tab = tabulate_1d(4)
    w3 = geometry.quadrature_weights_3d(tab)
    _, dphi = geometry.trilinear_tabulate(geometry.quadrature_points_3d(tab))
    sample = np.r_[0:2048, hm.ncells - 2048:hm.ncells]
    X = hm.cell_coords()[sample].astype(np.longdouble)
    J = np.einsum("cni,jqn->cqij", X, dphi.astype(np.longdouble))
    det = (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
           - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
           + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]))
    exact = np.abs(det) * w3.astype(np.longdouble)
    scale = float(np.abs(exact).max())
    card_x = float(np.abs(dwc.cpu().numpy()[sample] - exact).max()) / scale
    numpy_x = float(np.abs(dwn[sample] - exact).max()) / scale
    print(f"f64 G against NumPy {g_rel:.3e} of max|G| (limit 1e-13), detJw {dw_rel:.3e} "
          f"(limit 1e-13); clamp decisions that differ: {mismatch} (of {snapped} "
          f"snapped); detJw against 80-bit J on {len(sample)} cells: card {card_x:.3e} "
          f"(limit 1e-15), NumPy {numpy_x:.3e}")
    check(g_rel <= 1e-13 and dw_rel <= 1e-13 and mismatch == 0 and card_x <= 1e-15,
          "card geometry against NumPy and the extended-precision J")
    del Gn_raw, Gn, dwn, Gc_raw, Gc, X, J, det, exact

    # a degenerate cell (every vertex at one point) raises
    flat = HexMesh(points=np.zeros((8, 3)), cells=native.box_cells(1, 1, 1).numpy())
    try:
        geometry.precompute_geometric_data(flat, 2, device=dev)
        raised = False
    except ValueError as e:
        raised = "singular Jacobian" in str(e)
    check(raised, "a degenerate cell raises on the card")

    # each set-up kernel at the P8 shapes: against its plain version on the
    # card, back-to-back launches, the bound and a one-call PyTorch equivalent
    kl = _cuda.library()
    nc, nq, nd = hm.ncells, len(w3), 125
    cc = torch.as_tensor(hm.cell_coords(), device=dev)
    dp, w = (torch.as_tensor(a, device=dev) for a in (dphi, w3))
    out = {}
    Gk, dwk = native.geometry_factors_cuda(cc, dp, w)
    Gp, dwp = native.geometry_factors_plain(cc, dp, w)
    err = max(float((Gk - Gp).abs().max()), float((dwk - dwp).abs().max()))
    check(rel(Gk, Gp) <= 1e-13 and rel(dwk, dwp) <= 1e-15, "geometry kernel against plain")
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = 1e3 * timeit(_cuda.launcher(kl, "wave_geometry_factors", None, dev,
                                     *native.geometry_launch_args(cc, dp, w, True, Gk, dwk,
                                                                  flag)), reps=50)
    plain_ms = 1e3 * timeit(lambda: native.geometry_factors_plain(cc, dp, w), reps=3,
                            warmup=1)
    # the cells in, G and detJw out once; ~240 f64 flops a point
    out["geometry"] = (err, ms, plain_ms, bound(nbytes(cc, dp, w, Gk, dwk),
                                                240 * nc * nq), None)
    del Gk, dwk, Gp, dwp
    # the trilinear basis at the mirrored GLL nodes, as build_dofmap takes it
    ph = torch.as_tensor(node_phi(4), device=dev)
    keys, coords = native.node_keys_cuda(cc, ph, 1.0, 1e-9)
    kp, cp = native.node_keys_plain(cc, ph, 1.0, 1e-9)
    check(torch.equal(keys, kp) and torch.equal(coords, cp), "node keys bitwise the plain")
    ms = 1e3 * timeit(_cuda.launcher(kl, "wave_node_keys", None, dev, cc, ph, nc, nd,
                                     1.0 / 1e-9, keys, coords), reps=50)
    plain_ms = 1e3 * timeit(lambda: native.node_keys_plain(cc, ph, 1.0, 1e-9), reps=3,
                            warmup=1)
    # the cells in, keys and coordinates out once; 16 flops a component (the
    # sort's 19 compare-exchanges are not counted)
    out["keys"] = (0.0, ms, plain_ms, bound(nbytes(cc, ph, keys, coords), 48 * nc * nd),
                   None)
    ids, ndofs = native.dedup_dofs_cuda(keys)
    pids, pndofs = native.dedup_dofs_plain(keys)
    check(ndofs == pndofs == gmodel.ndofs and torch.equal(ids, pids), "dedup against plain")
    n = keys.shape[0]
    size = native.dedup_table_size(n)
    table = torch.empty(size, dtype=torch.int64, device=dev)
    rep = torch.empty(n, dtype=torch.int64, device=dev)
    hash_launch = _cuda.launcher(kl, "wave_dedup_hash", None, dev, keys, n, table, size - 1,
                                 rep, flag)

    def hashed():
        table.fill_(-1)
        hash_launch()

    ms = 1e3 * timeit(hashed, reps=20)
    wrapper_ms = 1e3 * timeit(lambda: native.dedup_dofs_cuda(keys), reps=10)
    plain_ms = 1e3 * timeit(lambda: native.dedup_dofs_plain(keys), reps=3, warmup=1)
    lib_ms = 1e3 * timeit(lambda: torch.unique(keys, dim=0, return_inverse=True), reps=3,
                          warmup=1)
    # the keys in, the ids out once
    out["dedup"] = (float((ids - pids).abs().max()), ms, plain_ms,
                    bound(nbytes(keys, ids), 0), lib_ms)
    for k, (e, t, tp, (b, by), lib) in out.items():
        print(f"set-up kernel {k}: {t:.4f} ms, plain {tp:.4f} ms, bound {b:.4f} ms ({by}), "
              f"max|err| against plain {e:.3e}" + (
                  f"; torch.unique(dim=0) {lib:.4f} ms, the wrapper (table fill, insert, "
                  f"lookup, numbering) {wrapper_ms:.4f} ms" if lib is not None else "")
              + f" [{smi}]")
    del cc, keys, coords, kp, cp, ids, pids, table, rep
    return {"np_setup": np_setup, "card_setup": gsetup, "card_setup2": gsetup2,
            "ndofs": dofs_np.ndofs, "dofmap": dofs_np.dofmap, "m": m_np, "W": W_np,
            "kernels": out, "dedup_wrapper_ms": wrapper_ms, "detJw_80bit": (card_x, numpy_x),
            "g_rel": g_rel, "dw_rel": dw_rel, "mismatch": mismatch}


#: cells a block on each axis of the dry run on the card (the JAX dry run's 2)
DRYRUN_CELLS_PER_BLOCK = 2


def slice_phases(dev, smi, counters: dict, setup_counters: dict) -> dict:
    """Phases 21-23: ``benchmarks/tsmm.py`` at the JAX defaults, the dry run
    (``apps/dryrun.py``) at 8 blocks and the four examples, each at its JAX
    size on the card. Each run is counted alone: every count set to 0 just
    before it and read just after. Returns each run's record and launches."""
    import numpy as np
    import torch

    from wave_fenics_tpu_torch.apps import dryrun
    from wave_fenics_tpu_torch.benchmarks import tsmm
    from wave_fenics_tpu_torch.core.basis import tabulate_1d
    from wave_fenics_tpu_torch.examples import (
        convergence_study,
        multichip_solve,
        plane_wave_validation,
        unstructured_distributed_solve,
    )
    from wave_fenics_tpu_torch.ops.element_kernels import apply_axis
    from wave_fenics_tpu_torch.utils.timing import timeit

    def zero():
        for fn in (*counters.values(), *setup_counters.values()):
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in counters.items() if fn.launches}

    out = {}
    # -- 21. tsmm ---------------------------------------------------------
    phase("tsmm (benchmarks/tsmm.py) at the JAX defaults: 100,000 cells, p=4, f32")
    nc, p = 100_000, 4
    zero()
    t0 = time.perf_counter()
    rec = tsmm.run(ncells=nc, degree=p, reps=100, dtype="f32", device="cuda", check=True)
    wall = time.perf_counter() - t0
    kernels = launched()
    print(json.dumps(rec))
    off = {"cuda_matmul_allow_tf32": False, "cudnn_allow_tf32": False,
           "float32_matmul_precision": "highest"}
    check(rec["tf32"] == off and not torch.backends.cuda.matmul.allow_tf32,
          f"tsmm ran with TF32 off: {rec['tf32']}")
    check(rec["max_rel_err_vs_f64"] <= 1e-5, "tsmm f32 against f64 on the first 1,000 cells")
    check(not kernels, f"tsmm launched no hand kernel (its contractions are einsums): "
          f"{kernels}")
    nd, nq = p + 1, p + 2  # a Gauss rule of exactness 2p + 2: p + 2 points
    check(rec["ndofs"] == nd**3 and rec["nq"] == nq**3, "tsmm's sizes")
    _, flops_sf = tsmm.flops(nc, nd, nq)
    # one pass: u read once, y written once; the six chained contractions
    # each read their input and write their output once
    t_bytes = 2 * nc * nd**3 * 4 / HBM_BYTES_PER_S
    t_ops = flops_sf / F32_FLOPS_PER_S
    chain = 2 * nc * (nd**3 + 2 * nq * nd**2 + 2 * nq**2 * nd + nq**3) * 4
    rec.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               chain_bytes_ms=1e3 * chain / HBM_BYTES_PER_S, seconds=wall)
    # where an apply's time goes: each of the six contractions alone, on its
    # own input (CUDA events over back-to-back calls)
    B = torch.as_tensor(tabulate_1d(p, q=2 * p + 2, rule="gauss").B, dtype=torch.float32,
                        device=dev)
    x = torch.randn((nc, nd, nd, nd), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    rec["contraction_ms"] = []
    for M, axis in ((B, 1), (B, 2), (B, 3), (B.T, 1), (B.T, 2), (B.T, 3)):
        rec["contraction_ms"].append(1e3 * timeit(lambda: apply_axis(x, M, axis), reps=50))
        x = apply_axis(x, M, axis)
    del x
    print(f"tsmm: {rec['ms_per_apply']:.4f} ms/apply ({rec['timing']}), "
          f"{rec['gflops']:.1f} GFLOP/s sum-factorized, {rec['gflops_ref']:.1f} on the dense "
          f"model; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; one pass of u and y, "
          f"{flops_sf / 1e9:.3f} GFLOP), the chain's own bytes {rec['chain_bytes_ms']:.4f} "
          f"ms; the six contractions alone "
          + ", ".join(f"{t:.4f}" for t in rec["contraction_ms"])
          + f" ms; f32 against f64 {rec['max_rel_err_vs_f64']:.3e} (limit 1e-5); TF32 flags "
          f"{rec['tf32']}; {wall:.1f} s [{smi}]")
    out["tsmm"] = rec

    # -- 22. the dry run ----------------------------------------------------
    phase(f"dry run (apps/dryrun.py) at 8 blocks on the card, f32, "
          f"{DRYRUN_CELLS_PER_BLOCK} cells a block on each axis")
    zero()
    t0 = time.perf_counter()
    r = dryrun.dryrun_multichip(8, device=dev, dtype=torch.float32,
                                cells_per_block=DRYRUN_CELLS_PER_BLOCK)
    wall = time.perf_counter() - t0
    kernels = launched()
    setup = {k: fn.launches for k, fn in setup_counters.items()}
    print(f"dry run: {wall:.2f} s; launches {kernels}, set-up {setup}; checks "
          + json.dumps(r["checks"]) + f"; CG {r['cg_iters']} iterations [{smi}]")
    check(set(kernels) == set("ABFHIJK"),
          f"the dry run launched A, B, F, H, I, J and K and no other kernel: {kernels}")
    check(r["step2_unavailable"] is None, "the dry run's 2-step RK4 ran")
    out["dryrun"] = {"launches": kernels, "setup_launches": setup, "checks": r["checks"],
                     "v_max": r["v_max"], "cg_iters": r["cg_iters"], "seconds": wall,
                     "cells_per_block": DRYRUN_CELLS_PER_BLOCK, "summary": r["summary"]}

    # -- 23. the four examples ------------------------------------------------
    examples = {}
    phase("examples/convergence_study.py: p in {2, 3, 4} x nx in {8, 12, 16}, f64, "
          "kernel F")
    zero()
    t0 = time.perf_counter()
    conv = convergence_study.main(["--device", "cuda"])
    kernels = launched()
    errs = list(conv["errors"].values())
    check(len(errs) == 9 and all(np.isfinite(e) and 0 < e < 1 for e in errs),
          f"the convergence table's errors {conv['errors']}")
    check(set(kernels) == {"F"}, f"convergence study launches {kernels}")
    examples["convergence_study"] = {
        "errors": {f"p={q} nx={n}": e for (q, n), e in conv["errors"].items()},
        "launches": kernels, "seconds": time.perf_counter() - t0}

    phase("examples/plane_wave_validation.py: (32,2,2) cells, f64, kernel F")
    zero()
    t0 = time.perf_counter()
    pw = plane_wave_validation.main(["--device", "cuda"])  # asserts rel < 1e-6
    kernels = launched()
    check(kernels == {"F": 4 * pw["steps"]}, f"plane wave launches {kernels}")
    examples["plane_wave_validation"] = {"rel_err": pw["rel_err"], "steps": pw["steps"],
                                         "launches": kernels,
                                         "seconds": time.perf_counter() - t0}

    phase("examples/multichip_solve.py 8: (2,2,2) blocks of 4^3 cells, f32, kernel B "
          "per block")
    zero()
    t0 = time.perf_counter()
    mc = multichip_solve.main(["8", "--device", "cuda"])
    kernels = launched()
    check(np.isfinite(mc["v"]).all() and mc["v_max"] > 0, "multichip v finite, nonzero")
    check(kernels == {"B": 8 * 4 * mc["steps"]}, f"multichip launches {kernels}")
    examples["multichip_solve"] = {"v_max": mc["v_max"], "steps": mc["steps"],
                                   "launches": kernels, "seconds": time.perf_counter() - t0}

    phase("examples/unstructured_distributed_solve.py 8: 8 RCB parts, f64, kernel K per "
          "part")
    zero()
    t0 = time.perf_counter()
    ud = unstructured_distributed_solve.main(["8", "--device", "cuda"])  # err < 1e-12
    kernels = launched()
    check(ud["route"] == "kernel K", f"the parts' route {ud['route']}")
    check(kernels == {"K": (8 + 1) * 4 * ud["steps"]},
          f"unstructured distributed launches {kernels}")
    examples["unstructured_distributed_solve"] = {
        "rel_err": ud["rel_err"], "ndofs": ud["ndofs"], "launches": kernels,
        "seconds": time.perf_counter() - t0}
    for name, e in examples.items():
        print(f"example {name}: " + json.dumps(e) + f" [{smi}]")
    out["examples"] = examples
    return out


def suite_phase(dev, smi, counters: dict, setup_counters: dict) -> dict:
    """Phase 27: ``benchmarks/suite.py --quick`` on the card, through its
    ``main`` (every benchmark in this process, the document under a
    temporary directory), counted alone: every count set to 0 just before
    it and read just after. The suite's entries run kernels A, B and D
    (the three headline records: 4 launches a step over the warm-up call,
    three windows of 50 steps and three of 12), F, G and K, and no other.
    Returns the summary, the headline records and the launches."""
    import torch

    from wave_fenics_tpu_torch.benchmarks import common, suite

    phase("phase 27: benchmarks/suite.py --quick on the card (every benchmark in one "
          "process; headline at 32x16x16 cells, p=4, 50 steps)")
    for fn in (*counters.values(), *setup_counters.values()):
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "BENCH_SUITE_torch.json")
        try:
            summary = suite.main(["--quick", "--out", out_path, "--device", "cuda"])
        except SystemExit as e:
            with open(out_path) as f:
                errors = [r for r in json.load(f)["results"] if "error" in r]
            raise RuntimeError(f"check failed: the quick suite exited {e.code}: "
                               f"{json.dumps(errors)[:2000]}") from None
        with open(out_path) as f:
            results = json.load(f)["results"]
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    name = torch.cuda.get_device_name(dev)
    heads = {r["metric"].rsplit(", ", 1)[-1].rstrip(")"): r for r in results
             if r.get("metric", "").startswith("planar3d RK4")}
    ceiling = common.stream_ceiling_gbps(dev)
    print(f"suite --quick: {summary['n']} records, {summary['errors']} errors, "
          f"{summary['seconds']:.1f} s; launches {launches} [{smi}]")
    for solver, r in heads.items():
        print(f"suite headline {solver}: " + json.dumps(r) + f" [{smi}]")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    buf = max(common.CEILING_BUFFER_BYTES, 4 * l2)
    print(f"streaming ceiling (a {buf >> 20} MiB device-to-device copy, L2 {l2 >> 20} MiB, "
          f"two-point): {ceiling:.1f} GB/s [{smi}]")
    print("suite " + json.dumps(summary))
    check(summary["errors"] == 0, "the quick suite ran with 0 errors")
    check(len(results) == summary["n"] == len(suite.entries(True)),
          "the quick suite wrote one record an entry")
    check(all(r.get("device") == name for r in results),
          f"every suite record ran on {name}")
    check(sorted(heads) == ["fused", "padded", "step"], f"the three headline records: "
          f"{sorted(heads)}")
    pct = summary.get("headline_pct_of_measured_ceiling")
    check(pct is not None and 0 < pct <= 100,
          f"0 < headline_pct_of_measured_ceiling = {pct} <= 100")
    check(summary["headline_gdof_steps_per_s"] == heads["step"]["value"],
          "the summary's headline is the step record")
    check(1500.0 <= ceiling <= 3350.0, f"the streaming ceiling {ceiling:.1f} GB/s within "
          "1,500-3,350 (above the card's 3.35 TB/s the timing or the bytes are wrong)")
    check(summary["stream_ceiling_gbps"] == ceiling, "the summary's ceiling")
    steps = 50 + 3 * 50 + 3 * 12  # warm-up call, three windows of 50 and of 12
    check(set(launches) == set("ABDFGK"),
          f"the suite launched A, B, D, F, G and K and no other kernel: {launches}")
    check(all(launches[k] == 4 * steps for k in "ABD"),
          f"each headline solver's kernel launched 4 x {steps} times: {launches}")
    return {"summary": summary, "headline": heads, "launches": launches,
            "ceiling_gbps": ceiling}


def bf16_phase(dev, smi, counters: dict, setup_counters: dict) -> dict:
    """Phase 24, bf16 state (kernels A, C, B, D and F): (a) each kernel
    against its plain bf16 twin at small sizes from NaN-filled outputs and
    scratch, one step, stage or apply within 1e-2 of max|ref| (about two
    bf16 ulps) with exactly zero padding, and a 25-step solve within 1.5x
    the plain bf16 run's own error against the plain f64 run from the same
    state; (b) the app's ``--dtype bf16`` at full width (P1: RK4 on A for
    the whole solve), counted alone, finite, max|u| at least half the f32
    run's (the source switched on), its relative L2 against f32 printed,
    and kernel A's path against the plain twin's at that width over 200
    steps within 1e-2; (c) each kernel's time at its PERF.md width beside
    the f32 kernel's in this call and the bound at 2 bytes a value, and at
    that width each bf16 kernel's output, from NaN, against its plain
    twin's on the same inputs (within 1e-2 of max|ref|, the padding
    exactly 0). Returns the launches, the checks' errors, the times and
    each part's seconds."""
    import numpy as np
    import torch

    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu_torch.models.linear_wave import LinearWave
    from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
    from wave_fenics_tpu_torch.ops import _cuda, rk4step, stiffness, wave
    from wave_fenics_tpu_torch.ops.operators import StructuredOperators
    from wave_fenics_tpu_torch.utils.timing import timeit

    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    out = {"checks": {}, "times": {}, "seconds": {}}
    t_part = time.perf_counter()

    def part_done(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds"][name] = now - t_part
        t_part = now

    def zero():
        for fn in (*counters.values(), *setup_counters.values()):
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in counters.items() if fn.launches}

    def model(p, dtype, device, cells=(4, 2, 2), tile_x=16, lean=True):
        mesh = box_mesh(cells, (0.01, 0.005, 0.005),
                        facet_tags=FacetTags({1: (0,), 2: (1,)}))
        return PaddedLinearWave(LinearWave(mesh, p=p, dtype=dtype, device=device),
                                tile_x=tile_x, lean=lean)

    def random_padded(layout, seed, scale=1.0):
        """float64 on the card, zero padding, its values bf16 numbers (so
        the bf16 and f64 runs start from one state)."""
        x = np.zeros(layout.padded_shape)
        x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(
            layout.shape)
        return torch.as_tensor(x, device=dev).to(bf16).to(f64)

    def rel(got, want):
        """max over fields of max|got - want| / max|want|."""
        return max(float((g.double() - w.double()).abs().max() / w.double().abs().max())
                   for g, w in zip(got, want))

    def nan_fill(pm):
        pairs, scratch = pm._workspace()
        for x in (*pairs[0], *pairs[1], *scratch):
            x.fill_(float("nan"))

    def padding_zero(layout, *xs):
        for x in xs:
            outside = x.clone()
            outside[layout.interior] = 0
            check(float(outside.abs().max()) == 0.0 and bool(torch.isfinite(x).all()),
                  "bf16: zero padding, no NaN")

    # -- (a) each kernel against its plain bf16 twin ---------------------------
    phase("phase 24, bf16 state: kernels A, C, B, D and F against their plain bf16 twins")
    zero()
    solvers = {"A": "solve_step_n", "C": "solve_step_n", "D": "solve_fused_n",
               "B": "solve_n"}
    cases = [("A", 2, (4, 2, 2)), ("A", 4, (4, 2, 2)), ("A", 4, (9, 4, 8)),
             ("C", 2, (4, 2, 2)), ("C", 4, (4, 2, 2)), ("D", 4, (4, 2, 2)),
             ("D", 8, (4, 2, 2)), ("B", 2, (4, 2, 2)), ("B", 4, (4, 2, 2))]
    for k, p, cells in cases:
        kw = dict(cells=cells, tile_x=max(16, rk4step._off0(p)), lean=k != "C")
        pm = model(p, bf16, dev, **kw)
        cpu16, cpu64 = model(p, bf16, "cpu", **kw), model(p, f64, "cpu", **kw)
        u0 = random_padded(pm.layout, 10 * p)
        v0 = random_padded(pm.layout, 10 * p + 1, scale=1e3)
        dt = 1e-9
        # one step (A, C, B: an apply of B in f1) or one stage (D)
        if k == "B":
            x = u0.to(bf16)
            got = (wave.apply_flat_cuda(x, pm.layout, pm.stencil,
                                        out=torch.full_like(x, float("nan"))),)
            want = (wave.apply_flat_plain(x.cpu(), cpu16.layout, cpu16.flat_tables),)
            what = "one apply"
        elif k == "D":
            ins = [random_padded(pm.layout, 100 * p + i, 1e3 if i % 2 else 1.0).to(bf16)
                   for i in range(6)]
            args = (0.5 * dt, dt / 3.0, 1.0, pm.layout, pm.base.c0)
            face = (pm.src_x, pm.abc_x)
            nan = tuple(torch.full_like(ins[0], float("nan")) for _ in range(4))
            got = wave.rk_stage_cuda(*ins, *args, pm.stencil, pm.face_w1, pm.face_w2,
                                     *face, out=nan)
            want = wave.rk_stage_plain(*(x.cpu() for x in ins), *args,
                                       cpu16.flat_tables, cpu16.face_w1,
                                       cpu16.face_w2, *face)
            what = "one stage"
        else:
            nan_fill(pm)
            got = getattr(pm, solvers[k])(0.0, dt, 1, u0.to(bf16), v0.to(bf16))[:2]
            want = getattr(cpu16, solvers[k])(0.0, dt, 1, u0.to(bf16).cpu(),
                                              v0.to(bf16).cpu())[:2]
            what = "one step"
        torch.cuda.synchronize()
        one = rel([g.cpu() for g in got], want)
        padding_zero(pm.layout, *got)
        # 25 steps: kernel bf16 and plain bf16 against plain f64
        ref = getattr(cpu64, solvers[k])(0.0, dt, 25, u0.cpu(), v0.cpu())[:2]
        if k != "B":
            nan_fill(pm)
        kern = getattr(pm, solvers[k])(0.0, dt, 25, u0.to(bf16), v0.to(bf16))[:2]
        plain = getattr(cpu16, solvers[k])(0.0, dt, 25, u0.to(bf16).cpu(),
                                           v0.to(bf16).cpu())[:2]
        torch.cuda.synchronize()
        padding_zero(pm.layout, *kern)
        e_k, e_p = rel([x.cpu() for x in kern], ref), rel(plain, ref)
        print(f"kernel {k} bf16 {cells} p={p}: {what} from NaN against the plain twin "
              f"{one:.3e} of max|ref| (limit 1e-2); 25 steps against plain f64: kernel "
              f"{e_k:.3e}, plain bf16 {e_p:.3e} (limit 1.5x)")
        check(one <= 1e-2, f"kernel {k} bf16 p={p} {cells}: {what}")
        check(e_k <= 1.5 * e_p, f"kernel {k} bf16 p={p} {cells}: 25 steps")
        out["checks"][f"{k} p={p} {cells}"] = {"one": one, "steps25_kernel": e_k,
                                               "steps25_plain": e_p}
    for p in (2, 4):  # kernel F: one apply, then LinearWave.solve, 25 steps
        mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                        facet_tags=FacetTags({1: (0,), 2: (1,)}))
        lw, lw16, lw64 = (LinearWave(mesh, p=p, dtype=dt_, device=d)
                          for dt_, d in ((bf16, dev), (bf16, "cpu"), (f64, "cpu")))
        ops = lw.ops
        tabs = stiffness.GridStiffnessTables(*ops._tensors(
            ("stiffness", -1500.0**2), dev, lambda: stiffness.stiffness_grid_tables(
                ops._sepA, ops._seplines, ops.grid_shape, p, -1500.0**2, bf16)))
        x = torch.as_tensor(np.random.default_rng(20 + p).standard_normal(
            ops.grid_shape), device=dev).to(bf16)
        yk = stiffness.stiffness_grid_cuda(x, tabs, p, out=torch.full_like(x, float("nan")))
        yp = stiffness.stiffness_grid_plain(x, tabs, p)
        torch.cuda.synchronize()
        one = rel([yk], [yp])
        check(bool(torch.isfinite(yk).all()), "kernel F bf16: every point written")
        u0 = torch.as_tensor(np.random.default_rng(30 + p).standard_normal(
            ops.grid_shape)).to(bf16)
        v0 = (1e3 * u0.double()).to(bf16)
        ref = lw64.solve(0.0, 25e-9, 1e-9, u0.double(), v0.double())[:2]
        kern = lw.solve(0.0, 25e-9, 1e-9, u0.to(dev), v0.to(dev))[:2]
        plain = lw16.solve(0.0, 25e-9, 1e-9, u0, v0)[:2]
        e_k, e_p = rel([x.cpu() for x in kern], ref), rel(plain, ref)
        print(f"kernel F bf16 (4,2,2) p={p}: one apply from NaN against the plain twin "
              f"{one:.3e} of max|ref| (limit 1e-2); LinearWave.solve 25 steps against "
              f"f64: kernel {e_k:.3e}, plain bf16 {e_p:.3e} (limit 1.5x)")
        check(one <= 1e-2 and e_k <= 1.5 * e_p, f"kernel F bf16 p={p}")
        out["checks"][f"F p={p} (4, 2, 2)"] = {"one": one, "steps25_kernel": e_k,
                                               "steps25_plain": e_p}
    out["launches"] = launched()
    part_done("a")
    print(f"phase 24 (a) launches: {out['launches']}; {out['seconds']['a']:.1f} s")

    # -- (b) the app at full width -----------------------------------------------
    phase("phase 24, bf16 state: the app's --dtype bf16 at the P1 configuration, kernel A")
    runs = {}
    for name in ("f32", "bf16"):
        zero()
        rec, u, _ = planar3d_app.run(cells=(64, 32, 32), degree=4, dtype=name,
                                     device="cuda", return_state=True)
        torch.cuda.synchronize()
        runs[name] = (rec, u.float(), launched())
    rec, u16, counts = runs["bf16"]
    rec32, u32, _ = runs["f32"]
    n = rec["nsteps"]
    want = {"A": 4 * (n + 1)}
    l2 = float((u16 - u32).norm() / u32.norm())
    m16, m32 = float(u16.abs().max()), float(u32.abs().max())
    print(f"bf16 app: {rec['ndofs']:,} dofs, {n} steps, {rec['solver_path']}; "
          f"launches {counts} (want {want}); max|u| {m16:.6e} against f32 {m32:.6e}; "
          f"relative L2 against f32 {l2:.6e}; solve {rec['solve_seconds']:.3f} s "
          f"(f32 {rec32['solve_seconds']:.3f} s) [{smi}]")
    check(rec["ndofs"] == 4_276_737 and counts == want, "bf16 app: kernel A only")
    # the source switched on (the JAX package's bf16 fused paths stay at 0).
    # No upper bound: a bf16 run of this scheme grows from some hundreds of
    # steps on, as the JAX package's bf16 solve_n does
    # (tests/test_torch_bf16.py::test_bf16_solve_n_grows_as_the_jax_package_does;
    # at this width apps/bf16_growth.py)
    check(bool(torch.isfinite(u16).all()) and m16 >= 0.5 * m32,
          "bf16 app: finite, the source switched on")
    # the kernel's path against the plain twin's at full width over the
    # steps before that growth amplifies their round-off
    _, pm = planar3d_app.build(cells=(64, 32, 32), degree=4, dtype="bf16",
                               device="cuda")
    dt, nk = rec["dt"], 200
    uk, vk, _ = pm.solve_step_n(0.0, dt, nk)
    up, vp = pm.zero_state()
    for i in range(nk):
        gs = [pm.base.g_amplitude((i + c) * dt) for c in (0.0, 0.5, 0.5, 1.0)]
        up, vp = rk4step.rk4_step_lean_plain(up, vp, dt, gs, pm.layout, pm.base.c0,
                                             pm.step_tables)
    torch.cuda.synchronize()
    twin = max(float((a.float() - b.float()).norm() / b.float().norm())
               for a, b in ((uk, up), (vk, vp)))
    del pm, uk, vk, up, vp
    part_done("b")
    print(f"bf16 P1, {nk} steps from 0: kernel A against the plain twin, relative "
          f"L2 {twin:.3e} (limit 1e-2); {out['seconds']['b']:.1f} s")
    check(twin <= 1e-2, "bf16 P1: kernel A against its plain twin")
    out["app"] = {"launches": counts, "nsteps": n, "rel_l2_vs_f32": l2,
                  "max_u": m16, "max_u_f32": m32, "solve_seconds": rec["solve_seconds"],
                  "solve_seconds_f32": rec32["solve_seconds"],
                  "solver_path": rec["solver_path"], "twin_200_steps_rel_l2": twin}

    # -- (c) times ---------------------------------------------------------------
    phase("phase 24, bf16 state: kernel times at their PERF.md widths, beside f32")

    def bound(nbytes, points, flops_per_point):
        """(bound_ms, bound_by): the bytes over the HBM rate against the
        flops over the f32 rate outside the tensor cores (the arithmetic is
        float32 in bf16 too)."""
        t_b = nbytes / HBM_BYTES_PER_S
        t_o = points * flops_per_point / F32_FLOPS_PER_S
        return {"bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations"}

    def launch_ms(name, dtype, args, reps=200):
        return 1e3 * timeit(_cuda.launcher(_cuda.library(), name, dtype, dev, *args),
                            reps=reps)

    def field_bytes(layout, dtype, interior=False):
        n = np.prod(layout.shape if interior else layout.padded_shape)
        return int(n) * torch.finfo(dtype).bits // 8

    def nan_like(x, n):
        return [torch.full_like(x, float("nan")) for _ in range(n)]

    def against_plain(k, got, want, layout=None):
        """A bf16 kernel's outputs (from NaN) at full width against its
        plain twin's on the same inputs; the padding exactly 0."""
        torch.cuda.synchronize()
        err = rel(got, want)
        if layout is not None:
            padding_zero(layout, *got)
        check(all(bool(torch.isfinite(g).all()) for g in got) and err <= 1e-2,
              f"kernel {k} bf16 at full width against its plain twin")
        out["checks"][f"{k} full width"] = {"one": err}
        return err

    for cells, p, kernels in (((64, 32, 32), 4, "AB"), ((32, 16, 16), 8, "D")):
        for dtype in (f32, bf16):
            pm = model(p, dtype, dev, cells=cells, tile_x=48 if p == 4 else 16)
            tab = sum(t.numel() * t.element_size()
                      for t in (*pm.stencil, pm.face_w1, pm.face_w2))
            fin, fout = (field_bytes(pm.layout, dtype, True), field_bytes(pm.layout, dtype))
            pts, apply = int(np.prod(pm.layout.shape)), 6 * (2 * p + 1) + 2
            u = random_padded(pm.layout, 3).to(dtype)
            v = random_padded(pm.layout, 4, 1e3).to(dtype)
            key = "bf16" if dtype == bf16 else "f32"
            if "A" in kernels:
                gs = [0.0] * 4
                for k, launcher, pointwise in (("A", "wave_rk4_stage", 20),
                                               ("C", "wave_rk4_full_stage", 30)):
                    plain = (rk4step.rk4_step_lean_plain if k == "A"
                             else rk4step.rk4_step_full_plain)
                    run_plain = lambda: plain(  # noqa: E731
                        u, v, 1e-9, gs, pm.layout, pm.base.c0, pm.step_tables)
                    plain_ms = 1e3 * timeit(run_plain, reps=3, warmup=1)
                    bufs = nan_like(u, 5)
                    us = []
                    for j in range(4):
                        args = rk4step.stage_launch_args(
                            j, u, v, *bufs[2:], bufs[2 + j] if j < 3 else bufs[4],
                            *bufs[:2], pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x, 1e-9,
                            gs[j], pm.base.c0, pm.layout, pm.stencil)
                        us.append(1e3 * launch_ms(launcher, dtype, args))
                    out["times"].setdefault(k, {})[key] = {
                        "ms_per_step": sum(us) / 1e3, "stage_us": us, "plain_ms": plain_ms,
                        **bound(2 * fin + 2 * fout + tab, pts, 4 * apply + pointwise),
                        "floor_ms": 1e3 * (11 * fin + 5 * fout) / HBM_BYTES_PER_S}
                    if dtype == bf16:  # the step the timed launches wrote
                        against_plain(k, bufs[:2], run_plain(), pm.layout)
                    del bufs
                y = torch.full_like(u, float("nan"))
                args = wave.flat_launch_args(u, y, pm.layout, pm.stencil)
                run_plain = lambda: wave.apply_flat_plain(  # noqa: E731
                    u, pm.layout, pm.flat_tables)
                out["times"].setdefault("B", {})[key] = {
                    "ms": launch_ms("wave_apply_flat_tiled", dtype, args),
                    "plain_ms": 1e3 * timeit(run_plain, reps=3, warmup=1),
                    **bound(fin + fout + tab, pts, apply)}
                if dtype == bf16:
                    against_plain("B", [y], [run_plain()], pm.layout)
                del y
            if "D" in kernels:
                ins = tuple(x.clone() for x in (u, u, v, v, u, v))
                bufs = tuple(nan_like(u, 4))
                args = wave.rk_stage_launch_args(
                    *ins, *bufs, 0.5e-9, 1e-9 / 3, 1.0, pm.layout, pm.base.c0,
                    pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
                run_plain = lambda: wave.rk_stage_plain(  # noqa: E731
                    *ins, 0.5e-9, 1e-9 / 3, 1.0, pm.layout, pm.base.c0,
                    pm.flat_tables, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
                out["times"].setdefault("D", {})[key] = {
                    "ms": launch_ms("wave_rk_stage_tiled", dtype, args),
                    "plain_ms": 1e3 * timeit(run_plain, reps=3, warmup=1),
                    **bound(6 * fin + 4 * fout + tab, pts, apply + 8)}
                if dtype == bf16:
                    against_plain("D", bufs, run_plain(), pm.layout)
                del ins, bufs
            del pm, u, v
    for dtype in (f32, bf16):
        ops = StructuredOperators(box_mesh((64, 64, 64), (1.0, 1.0, 1.0)), 4, dtype=dtype)
        tabs = stiffness.GridStiffnessTables(*ops._tensors(
            ("stiffness", -1500.0**2), dev, lambda: stiffness.stiffness_grid_tables(
                ops._sepA, ops._seplines, ops.grid_shape, 4, -1500.0**2, dtype)))
        x = torch.as_tensor(np.random.default_rng(21).standard_normal(ops.grid_shape),
                            device=dev).to(dtype)
        y = torch.full_like(x, float("nan"))
        args = stiffness.stiffness_launch_args(x, y, tabs, 4)
        key = "bf16" if dtype == bf16 else "f32"
        nb = 2 * x.numel() * x.element_size() + sum(t.numel() * t.element_size()
                                                     for t in tabs)
        run_plain = lambda: stiffness.stiffness_grid_plain(x, tabs, 4)  # noqa: E731
        out["times"].setdefault("F", {})[key] = {
            "ms": launch_ms("wave_stiffness_tiled", dtype, args),
            "plain_ms": 1e3 * timeit(run_plain, reps=3, warmup=1),
            **bound(nb, x.numel(), 6 * 9 + 8)}
        if dtype == bf16:  # the unpadded grid: every point written
            against_plain("F", [y], [run_plain()])
        del x, y
    part_done("c")
    for k, t in out["times"].items():
        a, b = t["bf16"], t["f32"]
        ms = "ms_per_step" if k in "AC" else "ms"
        extra = (f", stages {', '.join(f'{s:.2f}' for s in a['stage_us'])} us, "
                 f"4-launch floor {a['floor_ms']:.4f} ms (f32 {b['floor_ms']:.4f})"
                 if k in "AC" else "")
        print(f"kernel {k} bf16 {a[ms]:.4f} ms (bound {a['bound_ms']:.4f} ms, "
              f"{a['bound_by']}{extra}; plain twin {a['plain_ms']:.4f} ms) against f32 "
              f"{b[ms]:.4f} ms (bound {b['bound_ms']:.4f} ms, {b['bound_by']}; plain "
              f"{b['plain_ms']:.4f} ms) [{smi}]")
    print("bf16 at full width, kernel against its plain twin from NaN (limit 1e-2): "
          + ", ".join(f"{k} {out['checks'][f'{k} full width']['one']:.3e}"
                      for k in "ACBDF")
          + f"; phase 24 {sum(out['seconds'].values()):.1f} s (a {out['seconds']['a']:.1f}, "
          f"b {out['seconds']['b']:.1f}, c {out['seconds']['c']:.1f})")
    return out


def bf16_paths_phase(dev, smi, counters: dict, setup_counters: dict,
                     f32_states: dict) -> dict:
    """Phase 25, bf16 state on the leapfrog, two-step and p > 8 paths
    (kernels H, I, J and E): (a) each kernel against its plain bf16 twin
    on the CPU, on small grids of several y and z tiles, from NaN-filled
    outputs and scratch, one call within 1e-2 of max|ref| with exactly
    zero padding (H and I at p in {1, 3, 4, 8}, J and its step boundary at
    p in {1, 3, 4}, E at p in {9, 10} and kernel='3d' at p = 4); (b) the
    app's ``--dtype bf16`` at full width for the whole solve (P2 leapfrog
    on I, P3 p=8 leapfrog on H, P14 ``--two-step`` on J with A for the odd
    last step, P12 p=10 RK4 and P13 p=10 leapfrog on E), each counted
    alone: only its kernels, with PERF.md section 4's counts, finite,
    max|u| at least half the f32 run's (``f32_states``: phases 8 and 14's
    final states), its relative L2 against f32 and max|u| over f32's
    printed; then the kernel path against its plain twin's over 25 steps
    at that width within 1e-2 (relative L2); (c) E (P12), H (P3) and I
    (P2) phase by phase and J's step boundary (P1 width) in bf16 beside
    f32 in this call, against the bound at 2 bytes a value, and each bf16
    kernel's output from NaN at that width against its plain twin's on the
    same inputs (1e-2 of max|ref|, the padding exactly 0). Returns the
    launches, the checks' errors, the app runs, the times and each part's
    seconds."""
    import numpy as np
    import torch

    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu_torch.models.linear_wave import LinearWave
    from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
    from wave_fenics_tpu_torch.ops import _cuda, lf2step, lfstep, rk4step, rk42step, wave
    from wave_fenics_tpu_torch.solvers.leapfrog import leapfrog_solve_n
    from wave_fenics_tpu_torch.utils.timing import timeit

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"checks": {}, "app": {}, "times": {}, "seconds": {}}
    t_part = time.perf_counter()

    def part_done(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds"][name] = now - t_part
        t_part = now

    def zero():
        for fn in (*counters.values(), *setup_counters.values()):
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in counters.items() if fn.launches}

    def rel(got, want):
        """max over fields of max|got - want| / max|want|."""
        return max(float((g.double().cpu() - w.double().cpu()).abs().max()
                         / w.double().abs().max()) for g, w in zip(got, want))

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def padding_zero(layout, *xs):
        for x in xs:
            outside = x.clone()
            outside[layout.interior] = 0
            check(float(outside.abs().max()) == 0.0 and bool(torch.isfinite(x).all()),
                  "bf16: zero padding, no NaN")

    def state(layout, seed, scale=1.0, dtype=bf16):
        x = np.zeros(layout.padded_shape)
        x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(
            layout.shape)
        return torch.as_tensor(x, device=dev).to(dtype)

    def nan_like(x, n):
        return [torch.full_like(x, float("nan")) for _ in range(n)]

    # -- (a) each kernel against its plain bf16 twin at small sizes ------------
    phase("phase 25, bf16 state: kernels H, I, J and E against their plain bf16 twins")
    # several y and z tiles and x chunks at 2 bytes a value
    tiled = {1: (8, 10, 40), 3: (4, 4, 12), 4: (4, 3, 9), 8: (3, 2, 5)}

    def model(p, device, tile_x, cells, kernel="flat"):
        mesh = box_mesh(cells, (0.01, 0.005, 0.005),
                        facet_tags=FacetTags({1: (0,), 2: (1,)}))
        return PaddedLinearWave(LinearWave(mesh, p=p, dtype=bf16, device=device),
                                tile_x=tile_x, kernel=kernel)

    zero()
    dt, gs = 0.7e-9, (1.0e5, 0.7e5, 0.4e5, 0.1e5, -0.2e5)
    cases = [("H", p) for p in (1, 3, 4, 8)] + [("I", p) for p in (1, 3, 4, 8)] + [
        ("J", p) for p in (1, 3, 4)] + [("E", 9), ("E", 10), ("E 3d", 4)]
    for k, p in cases:
        if k == "J":
            tile, cells, kernel = max(24, rk42step._off0(p)), tiled[p], "flat"
        elif k.startswith("E"):
            tile, cells, kernel = 16, (4, 3, 9) if p == 4 else (2, 2, 4), k[2:] or "flat"
        else:
            tile, cells, kernel = max(16, lf2step._off0(p)), tiled[p], "flat"
        pm, pc = model(p, dev, tile, cells, kernel), model(p, "cpu", tile, cells, kernel)
        u0, v0 = state(pm.layout, 10 * p), state(pm.layout, 10 * p + 1, 1e3)
        nan = nan_like(u0, 8)
        if k.startswith("E"):
            check(pm.kernel == "3d", "kernel E: the 3D-slab layout")
            got = [wave.apply_slab_cuda(u0, pm.layout, pm.slab_tables, out=nan[0])]
            want = [wave.apply_slab_plain(u0.cpu(), pc.layout, pc.slab_tables)]
            scratch = []
        else:
            face = (pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
            cface = (pc.stencil, pc.face_w1, pc.face_w2, pc.src_x, pc.abc_x)
            if k == "H":
                got = lfstep.lf_step_cuda(u0, v0, dt, *gs[:2], pm.layout, pm.base.c0,
                                          *face, out=tuple(nan[:2]), scratch=nan[2])
                want = lfstep.lf_step_plain(u0.cpu(), v0.cpu(), dt, *gs[:2], pc.layout,
                                            pc.base.c0, pc.lf_tables)
                scratch = nan[2:3]
            elif k == "I":
                got = lf2step.lf2_step_cuda(u0, v0, dt, *gs[:3], pm.layout, pm.base.c0,
                                            *face, out=tuple(nan[:2]),
                                            scratch=tuple(nan[2:5]))
                want = lf2step.lf2_step_plain(u0.cpu(), v0.cpu(), dt, *gs[:3], pc.layout,
                                              pc.base.c0, pc.lf2_tables)
                scratch = nan[2:5]
            else:
                got = rk42step.rk42_step_cuda(u0, v0, 1e-9, gs, pm.layout, pm.base.c0,
                                              *face, out=tuple(nan[:2]),
                                              scratch=tuple(nan[2:]))
                want = rk42step.rk42_step_plain(u0.cpu(), v0.cpu(), 1e-9, gs, pc.layout,
                                                pc.base.c0, *cface)
                scratch = nan[2:]
                # the step boundary alone, from five random fields
                ins = [state(pm.layout, 20 * p + j, sc)
                       for j, sc in enumerate((1.0, 1e3, 1e9, 1e9, 1e9))]
                bgot = rk42step._rk42_boundary_cuda(
                    *ins, 1e-9, 0.5, pm.layout, pm.base.c0, *face,
                    out=tuple(nan_like(u0, 3)))
                bwant = rk42step.rk42_boundary_plain(*(x.cpu() for x in ins), 1e-9, 0.5,
                                                     pc.layout, pc.base.c0, *cface)
                torch.cuda.synchronize()
                berr = rel(bgot, bwant)
                padding_zero(pm.layout, *bgot)
                check(berr <= 1e-2, f"J's step boundary bf16 p={p}")
                out["checks"][f"J boundary p={p}"] = {"one": berr}
        torch.cuda.synchronize()
        one = rel(got, want)
        padding_zero(pm.layout, *got, *scratch)
        print(f"kernel {k} bf16 p={p} {cells}: one call from NaN against the plain twin "
              f"{one:.3e} of max|ref| (limit 1e-2)")
        check(one <= 1e-2, f"kernel {k} bf16 p={p}")
        out["checks"][f"{k} p={p}"] = {"one": one}
    out["launches"] = launched()
    part_done("a")
    print(f"phase 25 (a) launches: {out['launches']}; {out['seconds']['a']:.1f} s")

    # -- (b) the app at full width ---------------------------------------------
    runs = [
        ("P2 leapfrog, kernel I", dict(**HEADLINE, integrator="leapfrog"),
         lambda n: {"I": 3 * (n // 2 + 1), "H": 2 * (n % 2)}),
        ("P3 leapfrog p=8, kernel H", dict(**HEADLINE_P8, integrator="leapfrog"),
         lambda n: {"H": 2 * (n + 1)}),
        ("P14 RK4 two-step, kernel J", dict(**HEADLINE, two_step=True),
         lambda n: {"J": 7 * (n // 2 + 1), "A": 4 * (n % 2)}),
        ("P12 RK4 p=10, kernel E", dict(**P12), lambda n: {"E": 4 * (n + 1)}),
        ("P13 leapfrog p=10, kernel E", dict(**P12, integrator="leapfrog"),
         lambda n: {"E": (n + 1) + 2}),
    ]
    nk = 25
    for label, kw, want_of in runs:
        phase(f"phase 25, bf16 state: app path {label} with --dtype bf16")
        zero()
        rec, u, _ = planar3d_app.run(**kw, dtype="bf16", device="cuda", return_state=True)
        torch.cuda.synchronize()
        counts = launched()
        n = rec["nsteps"]
        want = {k: c for k, c in want_of(n).items() if c}
        u16, u32 = u.float(), f32_states[label].float()
        del u
        l2, m16, m32 = rel_l2(u16, u32), float(u16.abs().max()), float(u32.abs().max())
        print(f"bf16 {label}: {rec['ndofs']:,} dofs, {n} steps, {rec['solver_path']}; "
              f"launches {counts} (want {want}); max|u| {m16:.6e} against f32 {m32:.6e} "
              f"({m16 / m32:.4g}x); relative L2 against f32 {l2:.6e}; solve "
              f"{rec['solve_seconds']:.3f} s [{smi}]")
        check(counts == want, f"bf16 {label}: its kernels only, {want}")
        check("bf16 state" in rec["solver_path"], f"bf16 {label}: the bf16 path")
        # the source switched on (JAX's bf16 fused paths stay at 0); no
        # upper bound: a bf16 scheme grows where its tables' rows sum
        # above 0 (apps/bf16_growth.py)
        check(bool(torch.isfinite(u16).all()) and m16 >= 0.5 * m32,
              f"bf16 {label}: finite, the source switched on")
        del u16
        # the kernel path against its plain twin's at this width, nk steps
        _, pm = planar3d_app.build(**{k: v for k, v in kw.items()
                                      if k in ("cells", "degree")}, dtype="bf16",
                                   device="cuda")
        b, step_dt = pm.base, rec["dt"]
        g = b.g_amplitude
        up, vp = pm.zero_state()
        if label.startswith("P2"):
            uk, vk, _ = pm.solve_lf2_n(0.0, step_dt, nk)
            for i in range(0, nk - 1, 2):
                t = i * step_dt
                up, vp = lf2step.lf2_step_plain(up, vp, step_dt, g(t), g(t + step_dt),
                                                g(t + 2 * step_dt), pm.layout, b.c0,
                                                pm.lf2_tables)
            t = (nk - 1) * step_dt
            up, vp = lfstep.lf_step_plain(up, vp, step_dt, g(t), g(t + step_dt),
                                          pm.layout, b.c0, pm.lf_tables)
        elif label.startswith("P3"):
            uk, vk, _ = pm.solve_lf_n(0.0, step_dt, nk)
            for i in range(nk):
                t = i * step_dt
                up, vp = lfstep.lf_step_plain(up, vp, step_dt, g(t), g(t + step_dt),
                                              pm.layout, b.c0, pm.lf_tables)
        elif label.startswith("P14"):
            uk, vk, _ = pm.solve_step2_n(0.0, step_dt, nk)
            face = (pm.layout, b.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                    pm.abc_x)
            for i in range(0, nk - 1, 2):
                t = i * step_dt
                up, vp = rk42step.rk42_step_plain(
                    up, vp, step_dt, [g(t + j * 0.5 * step_dt) for j in range(5)], *face)
            t = (nk - 1) * step_dt
            up, vp = rk4step.rk4_step_lean_plain(
                up, vp, step_dt, [g(t + c * step_dt) for c in RK_C], pm.layout, b.c0,
                pm.step_tables)
        else:
            def solve(pm):
                if label.startswith("P12"):
                    return pm.solve_n(0.0, step_dt, nk)
                return leapfrog_solve_n(pm.force, pm.damping, *pm.zero_state(), 0.0,
                                        step_dt, nk)
            uk, vk = solve(pm)
            # the same model with kernel E's plain twin as its stiffness
            pm._apply = lambda x: wave.apply_slab_plain(x, pm.layout, pm.slab_tables)
            up, vp = solve(pm)
        torch.cuda.synchronize()
        check(float(vp.float().abs().max()) > 0, f"bf16 {label}: the twin's source on")
        twin = max(rel_l2(a, c) for a, c in ((uk, up), (vk, vp)))
        print(f"bf16 {label}, {nk} steps from 0: the kernel path against its plain twin, "
              f"relative L2 {twin:.3e} (limit 1e-2)")
        check(twin <= 1e-2, f"bf16 {label}: the kernel path against its plain twin")
        for k, c in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + c
        out["app"][label] = {"launches": counts, "nsteps": n, "rel_l2_vs_f32": l2,
                             "max_u": m16, "max_u_f32": m32,
                             "solve_seconds": rec["solve_seconds"],
                             "solver_path": rec["solver_path"],
                             f"twin_{nk}_steps_rel_l2": twin}
        del pm, uk, vk, up, vp
    part_done("b")
    print(f"phase 25 (b) {out['seconds']['b']:.1f} s")

    # -- (c) times at their PERF.md widths, beside f32 ----------------------------
    phase("phase 25, bf16 state: E, H, I and J's boundary at their PERF.md widths, "
          "beside f32")

    def launch_us(name, dtype, args, reps=200):
        return 1e6 * timeit(_cuda.launcher(_cuda.library(), name, dtype, dev, *args),
                            reps=reps)

    def bound(pm, ins, outs, applies, pointwise, tables=None):
        """(bound_ms, bound_by) by the rule of every bound of this script:
        the inputs' interiors in, the outputs' padded boxes out, the tables,
        at the state's bytes a value, against the flops at the f32 rate
        outside the tensor cores (the arithmetic is float32 in bf16)."""
        size = pm.base.dtype.itemsize
        if tables is None:
            tables = (*pm.stencil, pm.face_w1, pm.face_w2)
        nb = (ins * math.prod(pm.layout.shape) + outs * math.prod(pm.layout.padded_shape)
              ) * size + sum(t.numel() * t.element_size() for t in tables)
        K = 2 * pm.layout.p + 1
        flops = math.prod(pm.layout.shape) * (applies * (6 * K + 2) + pointwise)
        t_b, t_o = nb / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return {"bound_ms": 1e3 * max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o
                else "operations"}

    def against_plain(k, got, want, layout):
        torch.cuda.synchronize()
        err = rel(got, want)
        padding_zero(layout, *got)
        check(err <= 1e-2, f"kernel {k} bf16 at full width against its plain twin")
        out["checks"][f"{k} full width"] = {"one": err}

    for dtype in (f32, bf16):
        key = "bf16" if dtype == bf16 else "f32"
        name = "bf16" if dtype == bf16 else "f32"
        # E at P12
        _, pm = planar3d_app.build(**P12, dtype=name, device="cuda")
        x = state(pm.layout, 93, dtype=dtype)
        y = torch.full_like(x, float("nan"))
        args = wave.slab_launch_args(x, y, pm.layout, pm.slab_tables)
        run_plain = lambda: wave.apply_slab_plain(x, pm.layout, pm.slab_tables)  # noqa: E731
        out["times"].setdefault("E", {})[key] = {
            "ms": launch_us("wave_apply_slab_tiled", dtype, args) / 1e3,
            "plain_ms": 1e3 * timeit(run_plain, reps=3, warmup=1),
            **bound(pm, 1, 1, 1, 3, tables=pm.slab_tables)}
        if dtype == bf16:
            against_plain("E", [y], [run_plain()], pm.layout)
        del x, y, pm
        # H at P3 and I at P2, phase by phase
        for k, kw, phases, gs3 in (
                ("H", HEADLINE_P8, (("OPEN", lfstep.LF_OPEN), ("CLOSE", lfstep.LF_CLOSE)),
                 (1.0, 0.5)),
                ("I", HEADLINE, (("OPEN", lfstep.LF_OPEN), ("MID", lfstep.LF_MID),
                                 ("CLOSE", lfstep.LF_CLOSE)), (1.0, 0.5, 0.2))):
            case, pm = planar3d_app.build(**kw, dtype=name, device="cuda")
            ldt = case.dt * 0.71
            u, v = state(pm.layout, 3, dtype=dtype), state(pm.layout, 4, 1e3, dtype)
            bufs = nan_like(u, 5)
            face = (pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                    pm.abc_x)
            us = {}
            for (pname, ph), g in zip(phases, gs3):
                args = lfstep.lf_launch_args(
                    ph, u, v, None if ph == lfstep.LF_CLOSE else bufs[0], bufs[1], ldt,
                    g, *face)
                us[pname] = launch_us("wave_lf_phase_tiled", dtype, args)
            if k == "H":
                run_plain = lambda: lfstep.lf_step_plain(  # noqa: E731
                    u, v, ldt, *gs3, pm.layout, pm.base.c0, pm.lf_tables)
                run_kernel = lambda: lfstep.lf_step_cuda(  # noqa: E731
                    u, v, ldt, *gs3, *face, out=tuple(bufs[:2]), scratch=bufs[2])
                b = bound(pm, 2, 2, 2, 12)
            else:
                run_plain = lambda: lf2step.lf2_step_plain(  # noqa: E731
                    u, v, ldt, *gs3, pm.layout, pm.base.c0, pm.lf2_tables)
                run_kernel = lambda: lf2step.lf2_step_cuda(  # noqa: E731
                    u, v, ldt, *gs3, *face, out=tuple(bufs[:2]), scratch=tuple(bufs[2:]))
                b = bound(pm, 2, 2, 3, 24)
            out["times"].setdefault(k, {})[key] = {
                "ms": sum(us.values()) / 1e3, "phase_us": us,
                "plain_ms": 1e3 * timeit(run_plain, reps=3, warmup=1), **b}
            if dtype == bf16:  # from NaN in the outputs and the scratch
                for x in bufs:
                    x.fill_(float("nan"))
                against_plain(k, run_kernel(), run_plain(), pm.layout)
            del u, v, bufs, pm
        # J's step boundary at the P1 width
        _, pm = planar3d_app.build(**HEADLINE, dtype=name, device="cuda")
        ins = [state(pm.layout, 70 + j, sc, dtype)
               for j, sc in enumerate((1.0, 1e3, 1e9, 1e9, 1e9))]
        outs = nan_like(ins[0], 3)
        bface = (pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                 pm.abc_x)
        args = rk42step.boundary_launch_args(
            *ins, *outs, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x, 1e-9, 0.5,
            pm.base.c0, pm.layout, pm.stencil)
        run_plain = lambda: rk42step.rk42_boundary_plain(  # noqa: E731
            *ins, 1e-9, 0.5, *bface)
        out["times"].setdefault("J", {})[key] = {
            "ms": launch_us("wave_rk42_boundary_tiled", dtype, args) / 1e3,
            "plain_ms": 1e3 * timeit(run_plain, reps=3, warmup=1),
            **bound(pm, 5, 3, 2, 30)}
        if dtype == bf16:  # the timed launches wrote outs from the same inputs
            against_plain("J boundary", outs, run_plain(), pm.layout)
        del ins, outs, pm
    part_done("c")
    for k, t in out["times"].items():
        a, c = t["bf16"], t["f32"]
        what = "J's step boundary" if k == "J" else f"kernel {k}"
        phases = (f", phases {', '.join(f'{n} {x:.2f}' for n, x in a['phase_us'].items())}"
                  f" us (f32 {', '.join(f'{n} {x:.2f}' for n, x in c['phase_us'].items())})"
                  if "phase_us" in a else "")
        print(f"{what} bf16 {a['ms']:.4f} ms (bound {a['bound_ms']:.4f} ms, "
              f"{a['bound_by']}{phases}; plain twin {a['plain_ms']:.4f} ms) against f32 "
              f"{c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms, {c['bound_by']}; plain "
              f"{c['plain_ms']:.4f} ms) [{smi}]")
    print("bf16 at full width, kernel against its plain twin from NaN (limit 1e-2): "
          + ", ".join(f"{k} {out['checks'][f'{k} full width']['one']:.3e}"
                      for k in ("E", "H", "I", "J boundary"))
          + f"; phase 25 {sum(out['seconds'].values()):.1f} s (a {out['seconds']['a']:.1f}, "
          f"b {out['seconds']['b']:.1f}, c {out['seconds']['c']:.1f})")
    return out


def bf16_rest_phase(dev, smi, counters: dict, setup_counters: dict, f32_apps: dict,
                    csr16) -> dict:
    """Phase 26, bf16 state on kernels G and K, the imported mesh, the
    sharded paths and the benchmarks: (a) G (p in {1, 2, 4, 8} on two
    small grids, and at P7's grid) and K (collocated p in {2, 4, 6}, Gauss
    p in {2, 4}, affine cells at p=4; and at P8 in its four modes) against
    their plain bf16 twins on the card, from NaN-filled outputs: one apply
    within 1e-2 of max|ref|, G's padding exactly 0, two K applies bitwise
    equal; (b) G at P7 and K's four modes at P8 in bf16 beside f32 in this
    call (CUDA events), against the bound at 2 bytes a value, with G's
    bf16 ``torch.einsum`` of the three assembled 1D masses and K's bf16
    CSR ``torch.sparse.mm`` at 16^3 cells (``csr16``: the f32 matrix, its
    mesh and dofmap) beside K there; (c) the app's ``--dtype bf16`` to tf on
    its kernels only: P16 (``--mesh``, K 4 x (n + 1)), P20's ``--ndev 4``
    RK4 (A 4 x 4 x (n + 1)) and leapfrog (H 2 x 4 x (n + 1)) and P21's
    ``--mesh --ndev 4`` (K 4 x 4 x (n + 1)), each counted alone, finite,
    max|u| over the f32 run's (``f32_apps``: phases 15, 17 and 18's
    records) printed; then each path against its twin over 25 steps: P16's
    kernel path against the plain K twin (1e-2), the sharded paths against
    one device's bf16 kernel path (bit for bit for the value halos, whose
    blocks hold one device's tables; 2e-2 for the parts' additive
    assembly); (d)
    ``cg_bench`` BP1 at P6 and ``--op general``, ``operators_bench``
    bp1-mass and K's four ops with ``--check``, ``general_solve`` at P8,
    ``scatter_bench``'s three modes and ``tsmm``, each with ``--dtype bf16``
    and its JSON line printed. Returns the launches, checks, times, app
    runs, benchmark records and each part's seconds."""
    import copy

    import numpy as np
    import torch

    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.benchmarks import (cg_bench, general_solve,
                                                  operators_bench, scatter_bench, tsmm)
    from wave_fenics_tpu_torch.core.dofmap import build_dofmap
    from wave_fenics_tpu_torch.core.io import write_xdmf_mesh, write_xdmf_meshtags
    from wave_fenics_tpu_torch.core.mesh import box_mesh
    from wave_fenics_tpu_torch.ops import _cuda, general, mass
    from wave_fenics_tpu_torch.ops.operators import GeneralOperators
    from wave_fenics_tpu_torch.ops.separable import separable_mass_tables
    from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave
    from wave_fenics_tpu_torch.utils.config import SimulationConfig
    from wave_fenics_tpu_torch.utils.timing import timeit

    bf16, f32 = torch.bfloat16, torch.float32
    C0SQ = 1500.0**2
    out = {"checks": {}, "app": {}, "times": {}, "bench": {}, "seconds": {},
           "launches": {}}
    t_part = time.perf_counter()

    def part_done(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds"][name] = now - t_part
        t_part = now

    def zero():
        for fn in (*counters.values(), *setup_counters.values()):
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in counters.items() if fn.launches}

    def add_launches(counts):
        for k, c in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + c

    def rel(got, want):
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def padding_zero(layout, x):
        outside = x.clone()
        outside[layout.interior] = 0
        check(float(outside.abs().max()) == 0.0 and bool(torch.isfinite(x).all()),
              "bf16: zero padding, no NaN")

    def padded_state(layout, seed, dtype=bf16):
        x = np.zeros(layout.padded_shape)
        x[layout.interior] = np.random.default_rng(seed).standard_normal(layout.shape)
        return torch.as_tensor(x, device=dev).to(dtype)

    def dofs_state(n, seed, dtype=bf16):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                               device=dev).to(dtype)

    def bound(nbytes, flops):
        """(bound_ms, bound_by): the bytes over the HBM rate against the
        flops at the f32 rate outside the tensor cores (the arithmetic is
        float32 in bf16)."""
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return {"bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations"}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def k_bound(t, itemsize):
        """x and y once at ``itemsize``, the dofmap and the geometry (as
        stored), against the contractions' flops (chip_smoke's rule for K;
        the zero pass, the colours' reads of y and bf16's float32 workspace
        are the design's own traffic, not counted)."""
        m, nq, nc, nd = t.m, t.nq, t.ncells, t.m**3
        nb = 2 * t.ndofs * itemsize + nbytes(t.dofmap, t.geo, t.w)
        fwd = 2 * m * (nq * m * m + nq * nq * m + nq**3)
        bwd = 2 * nq * (m * nq * nq + m * m * nq + m**3)
        per_cell = {"mass": 2 * nd, "stiffness": nd * (12 * m + 16),
                    "mass_gauss": fwd + nq**3 + bwd + nd,
                    "stiffness_gauss": 3 * fwd + 15 * nq**3 + 3 * bwd + nd}[t.mode]
        return bound(nb, nc * (per_cell + nd))

    # -- (a) G and K against their plain bf16 twins ------------------------------
    phase("phase 26, bf16 state: kernels G and K against their plain bf16 twins")
    zero()
    worst = 0.0
    for p in (1, 2, 4, 8):
        for cells in ((3, 2, 2), (5, 3, 4)):
            lay, tabs, _ = mass.bp1_setup(box_mesh(cells, (1.0, 0.8, 1.2)), p, bf16, dev)
            x = padded_state(lay, 30 + p)
            y = mass.mass_apply_cuda(x, lay, tabs, out=torch.full_like(x, float("nan")))
            e = rel(y, mass.mass_apply_zyx_plain(x, lay, tabs))
            padding_zero(lay, y)
            check(e <= 1e-2, f"kernel G bf16 p={p} {cells} against its plain twin")
            worst = max(worst, e)
    out["checks"]["G small"] = worst
    mesh64 = box_mesh((BP1["size"],) * 3, (1.0, 1.0, 1.0))
    glay, gtabs, _ = mass.bp1_setup(mesh64, BP1["degree"], bf16, dev)
    gx = padded_state(glay, 31)
    gy = mass.mass_apply_cuda(gx, glay, gtabs, out=torch.full_like(gx, float("nan")))
    e = rel(gy, mass.mass_apply_zyx_plain(gx, glay, gtabs))
    padding_zero(glay, gy)
    check(e <= 1e-2, "kernel G bf16 at P7 against its plain twin")
    out["checks"]["G P7"] = e
    worst = 0.0
    cases = [("gll", 2, False), ("gll", 4, False), ("gll", 6, False), ("gauss", 2, False),
             ("gauss", 4, False), ("gll", 4, True)]
    for rule, p, affine in cases:
        if affine:
            hm = box_mesh((5, 4, 3), (1.0, 0.8, 0.9)).to_hex_mesh()
        else:
            hm, _ = general_solve.perturbed_box((5, 4, 3) if p < 6 else (3, 2, 2), h=0.25)
        ops = GeneralOperators(hm, build_dofmap(hm, p), dtype=bf16, rule=rule)
        check(ops.affine == affine, f"K bf16 {rule} p={p}: affine {affine}")
        x = dofs_state(ops.ndofs, 40 + p)
        for op, coeff in (("mass", 1.0), ("stiffness", -C0SQ)):
            t = ops.tables(ops.mode(op), dev)
            y = general.general_apply_cuda(x, t, coeff, out=torch.full_like(x, float("nan")))
            y2 = general.general_apply_cuda(x, t, coeff)
            e = rel(y, general.general_apply_plain(x, t, coeff))
            check(e <= 1e-2 and torch.equal(y, y2),
                  f"kernel K bf16 {t.mode} p={p} affine={affine}: against its twin, "
                  "bitwise repeatable")
            worst = max(worst, e)
    out["checks"]["K small"] = worst
    # K at P8 in its four modes
    gm16, gm_setup = general_solve.build(HEADLINE["cells"], 4, "bf16")
    k_ops = {"gll": gm16.ops, "gauss": GeneralOperators(
        gm16.mesh, gm16.dofs, dtype=bf16, rule="gauss", device=dev)}
    k_modes = (("stiffness", "gll", -C0SQ), ("mass", "gll", 1.0),
               ("mass_gauss", "gauss", 1.0), ("stiffness_gauss", "gauss", -C0SQ))
    kx = dofs_state(gm16.ndofs, 70)
    for mode, rule, coeff in k_modes:
        t = k_ops[rule].tables(mode, dev)
        y = general.general_apply_cuda(kx, t, coeff, out=torch.full_like(kx, float("nan")))
        y2 = general.general_apply_cuda(kx, t, coeff)
        e = rel(y, general.general_apply_plain(kx, t, coeff))
        check(e <= 1e-2 and torch.equal(y, y2) and bool(torch.isfinite(y).all()),
              f"kernel K bf16 {mode} at P8 against its twin, bitwise repeatable")
        out["checks"][f"K P8 {mode}"] = e
        del y, y2
    add_launches(launched())
    part_done("a")
    print(f"phase 26 (a): G small {out['checks']['G small']:.3e}, P7 "
          f"{out['checks']['G P7']:.3e}; K small {out['checks']['K small']:.3e}, P8 "
          + ", ".join(f"{m} {out['checks'][f'K P8 {m}']:.3e}" for m, _, _ in k_modes)
          + f" (limit 1e-2); P8 bf16 model set-up {gm_setup:.2f} s; launches "
          f"{out['launches']}; {out['seconds']['a']:.1f} s")

    # -- (b) times beside f32 ---------------------------------------------------
    phase("phase 26, bf16 state: G at P7 and K's four modes at P8 beside f32")

    def launch_ms(name, x, args, reps=200):
        return 1e3 * timeit(_cuda.launcher(_cuda.library(), name, x.dtype, dev, *args),
                            reps=reps)

    glay32, gtabs32, _ = mass.bp1_setup(mesh64, BP1["degree"], f32, dev)
    gops32 = {"gll": general_solve.build(HEADLINE["cells"], 4, "f32")[0].ops}
    gops32["gauss"] = GeneralOperators(gops32["gll"].mesh, gops32["gll"].dofs, dtype=f32,
                                       rule="gauss", device=dev)
    for dtype in (f32, bf16):
        key = "bf16" if dtype == bf16 else "f32"
        lay, tabs = (glay, gtabs) if dtype == bf16 else (glay32, gtabs32)
        x = gx if dtype == bf16 else padded_state(glay32, 31, f32)
        y = torch.empty_like(x)
        n_int = math.prod(lay.shape)
        out["times"].setdefault("G", {})[key] = {
            "ms": launch_ms("wave_mass_tiled", x, mass.mass_launch_args(x, y, lay, tabs)),
            "plain_ms": 1e3 * timeit(lambda: mass.mass_apply_zyx_plain(x, lay, tabs),
                                     reps=3, warmup=1),
            **bound(n_int * x.element_size() + nbytes(y, *tabs), n_int * 6 * 9)}
        ops = k_ops if dtype == bf16 else gops32
        xk = kx if dtype == bf16 else dofs_state(gm16.ndofs, 70, f32)
        yk = torch.empty_like(xk)
        for mode, rule, coeff in k_modes:
            t = ops[rule].tables(mode, dev)
            out["times"].setdefault(f"K {mode}", {})[key] = {
                "ms": launch_ms("wave_general_apply", xk,
                                general.launch_args(xk, yk, t, coeff), reps=100),
                "plain_ms": 1e3 * timeit(lambda: general.general_apply_plain(xk, t, coeff),
                                         reps=2, warmup=1),
                **k_bound(t, xk.element_size())}
        del x, y, xk, yk
    del gops32, glay32, gtabs32
    # G's one-call equivalent in bf16: the three assembled 1D masses (bf16)
    M1 = separable_mass_tables(BP1["degree"], mesh64.h, np.float64)
    mats = []
    for d, n in enumerate(mesh64.shape):
        pg = BP1["degree"]
        A1 = np.zeros((n * pg + 1, n * pg + 1))
        for c in range(n):
            A1[c * pg:c * pg + pg + 1, c * pg:c * pg + pg + 1] += M1[d]
        mats.append(torch.as_tensor(A1, device=dev).to(bf16))
    xg = gx[glay.interior].contiguous()
    y_lib = torch.einsum("ijk,ai,bj,ck->abc", xg, *mats)
    e_lib = rel(gy[glay.interior], y_lib)
    lib_ms = 1e3 * timeit(lambda: torch.einsum("ijk,ai,bj,ck->abc", xg, *mats))
    check(e_lib <= 3e-2, "kernel G bf16 against the bf16 einsum of the 1D masses")
    out["times"]["G"]["bf16"]["library_ms"] = lib_ms
    out["checks"]["G against the bf16 einsum"] = e_lib
    del mats, xg, y_lib, gy
    # K's one-call equivalent in bf16: the assembled CSR at 16^3 cells
    A16, hm16, dofs16 = csr16
    ops16 = GeneralOperators(hm16, dofs16, dtype=bf16)
    t16 = ops16.tables("stiffness", dev)
    x16 = dofs_state(ops16.ndofs, 80)
    y16 = torch.empty_like(x16)
    k16_ms = launch_ms("wave_general_apply", x16, general.launch_args(x16, y16, t16, -C0SQ))
    try:
        A16b = torch.sparse_csr_tensor(A16.crow_indices(), A16.col_indices(),
                                       A16.values().to(bf16), A16.shape)
        y_csr = torch.sparse.mm(A16b, x16[:, None])[:, 0]
        e_csr = rel(general.general_apply_cuda(x16, t16, -C0SQ), y_csr.float())
        csr_ms = 1e3 * timeit(lambda: torch.sparse.mm(A16b, x16[:, None]))
        csr_note = "torch.sparse.mm of the bf16 CSR"
        check(e_csr <= 3e-2, "kernel K bf16 against the bf16 CSR SpMV")
    except (RuntimeError, NotImplementedError) as exc:
        e_csr, csr_ms = None, None
        csr_note = f"not in torch: {type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    out["times"]["K 16^3"] = {"bf16": {"ms": k16_ms, "library_ms": csr_ms,
                                       "library": csr_note, "rel_err_vs_library": e_csr,
                                       **k_bound(t16, 2)}}
    del A16, x16, y16
    part_done("b")
    for k, t in out["times"].items():
        if "f32" not in t:
            continue
        a, c = t["bf16"], t["f32"]
        lib = f"; bf16 einsum {a['library_ms']:.4f} ms" if "library_ms" in a else ""
        print(f"{k} bf16 {a['ms']:.4f} ms (bound {a['bound_ms']:.4f} ms, {a['bound_by']}; "
              f"plain twin {a['plain_ms']:.4f} ms{lib}) against f32 {c['ms']:.4f} ms "
              f"(bound {c['bound_ms']:.4f} ms; plain {c['plain_ms']:.4f} ms) [{smi}]")
    k16 = out["times"]["K 16^3"]["bf16"]
    print(f"K stiffness bf16 at 16^3 cells {k16['ms']:.4f} ms (bound {k16['bound_ms']:.4f} "
          f"ms); {k16['library']}: {k16['library_ms']} ms, K against it "
          f"{k16['rel_err_vs_library']} [{smi}]; phase 26 (b) {out['seconds']['b']:.1f} s")

    # -- (c) the app to tf on its kernels, and each path against its twin ---------
    nk = 25
    with tempfile.TemporaryDirectory(prefix="_p26_", dir=ROOT) as tmp:
        mesh_path, tags_path = os.path.join(tmp, "mesh.xdmf"), os.path.join(tmp, "tags.xdmf")
        ft = gm16.facet_tags
        write_xdmf_mesh(mesh_path, gm16.mesh)
        write_xdmf_meshtags(tags_path, gm16.mesh, np.concatenate([ft[1], ft[2]]),
                            [1] * len(ft[1]) + [2] * len(ft[2]))
        cfg16 = SimulationConfig()
        cfg16.domain.mesh_path, cfg16.domain.meshtags_path = mesh_path, tags_path
        cfg21 = SimulationConfig.from_json(cfg16.to_json())
        cfg21.run.ndev = 4
        runs = [("P16 --mesh", dict(config=cfg16), "K", lambda n: 4 * (n + 1)),
                ("P20 --ndev 4 rk4", dict(**HEADLINE, ndev=4), "A",
                 lambda n: 4 * 4 * (n + 1)),
                ("P20 --ndev 4 leapfrog", dict(**HEADLINE, ndev=4, integrator="leapfrog"),
                 "H", lambda n: 2 * 4 * (n + 1)),
                ("P21 --mesh --ndev 4", dict(config=cfg21), "K",
                 lambda n: 4 * 4 * (n + 1))]
        for label, kw, kernel, want_of in runs:
            phase(f"phase 26, bf16 state: the app's {label} --dtype bf16")
            zero()
            cfg = kw.pop("config", None)
            rec = (planar3d_app.run(cfg, dtype="bf16", device="cuda", **kw) if cfg is not None
                   else planar3d_app.run(**kw, dtype="bf16", device="cuda"))
            torch.cuda.synchronize()
            counts = launched()
            n = rec["nsteps"]
            want = {kernel: want_of(n)}
            m32 = f32_apps[label]["u_max"]
            ratio = rec["u_max"] / m32
            print(f"bf16 {label}: {rec['ndofs']:,} dofs, {n} steps, {rec['solver_path']}; "
                  f"launches {counts} (want {want}); max|u| {rec['u_max']:.6e} against f32 "
                  f"{m32:.6e} ({ratio:.4g}x); solve {rec['solve_seconds']:.3f} s [{smi}]")
            check(counts == want, f"bf16 {label}: its kernel only, {want}")
            check(rec["dtype"] == "bf16" and math.isfinite(rec["u_max"])
                  and rec["u_max"] > 0, f"bf16 {label}: finite, the source on")
            add_launches(counts)
            out["app"][label] = {"launches": counts, "nsteps": n, "max_u": rec["u_max"],
                                 "max_u_f32": m32, "max_u_over_f32": ratio,
                                 "solve_seconds": rec["solve_seconds"],
                                 "setup_seconds": rec["setup_seconds"],
                                 "solver_path": rec["solver_path"]}
        part_done("c app")
    # the twins over nk steps from rest
    case16 = planar3d_app.build(cells=HEADLINE["cells"], degree=4, dtype="bf16",
                                device="cuda")[0]
    dt_box = case16.dt
    from wave_fenics_tpu_torch.models.planar3d import general_case

    dt_gen = general_case(gm16).dt
    uk, vk = gm16.solve_n(0.0, dt_gen, nk)
    twin = copy.copy(gm16)
    twin.ops = general.PlainK(gm16.ops)
    up, vp = twin.solve_n(0.0, dt_gen, nk)
    e = max(rel_l2(uk, up), rel_l2(vk, vp))
    check(e <= 1e-2 and float(vp.float().abs().max()) > 0,
          "P16 bf16: the kernel path against the plain K twin")
    out["app"]["P16 --mesh"]["twin_rel_l2"] = e
    del uk, vk, up, vp, twin
    # a value-halo refresh copies values and each block's tables hold one
    # device's values, so the blocks give one device's bf16 state bit for bit
    _, pm = planar3d_app.build(**HEADLINE, dtype="bf16", device="cuda", tile_x=16)
    sw = ShardedPaddedWave(pm.base, (2, 2, 1), tile_x=16)
    for label, solver, to_global, dt_run in (
            ("P20 --ndev 4 rk4", "solve_step_n", "to_global_step", dt_box),
            ("P20 --ndev 4 leapfrog", "solve_lf_n", "to_global_lf", dt_box * 0.71)):
        u, v, _ = getattr(sw, solver)(0.0, dt_run, nk)
        ur, vr = getattr(pm, solver)(0.0, dt_run, nk)[:2]
        pairs = [(torch.as_tensor(getattr(sw, to_global)(a)), pm.to_grid(b).float().cpu())
                 for a, b in ((u, ur), (v, vr))]
        e = max(rel_l2(a, b) for a, b in pairs)
        ndiff = sum(int((a != b).sum()) for a, b in pairs)
        print(f"{label} bf16, {nk} steps: the blocks against one device's kernel path, "
              f"relative L2 {e:.3e}, {ndiff} points differ (limit 0)")
        check(ndiff == 0 and float(pairs[1][1].abs().max()) > 0,
              f"{label} bf16: the blocks bit for bit one device's")
        out["app"][label]["twin_rel_l2"] = e
        del u, v, ur, vr, pairs
    del sw, pm
    sg = ShardedGeneralWave(gm16, 4).prepare()
    u, v, _ = sg.solve_n(0.0, dt_gen, nk)
    ur, vr = gm16.solve_n(0.0, dt_gen, nk)
    e = max(rel_l2(torch.as_tensor(sg.to_global(a)), b.cpu()) for a, b in ((u, ur), (v, vr)))
    print(f"P21 bf16, {nk} steps: the parts against one device's kernel path, relative L2 "
          f"{e:.3e} (limit 2e-2)")
    check(e <= 2e-2, "P21 bf16: the parts against one device's kernel path")
    out["app"]["P21 --mesh --ndev 4"]["twin_rel_l2"] = e
    del sg, u, v, ur, vr
    part_done("c twins")
    print("phase 26 (c) against the twins over 25 steps (relative L2): "
          + ", ".join(f"{k} {a['twin_rel_l2']:.3e}" for k, a in out["app"].items())
          + f"; app {out['seconds']['c app']:.1f} s, twins {out['seconds']['c twins']:.1f} s")

    # -- (d) every benchmark's --dtype bf16 ---------------------------------------
    benches = [
        ("cg_bench bp1 P6", lambda: cg_bench.run(op="bp1", size=BP1["size"],
                                                 degree=BP1["degree"], dtype="bf16")),
        ("cg_bench general", lambda: cg_bench.run(op="general", s=12, degree=4,
                                                  dtype="bf16")),
        ("operators_bench bp1-mass", lambda: operators_bench.run(
            op="bp1-mass", size=BP1["size"], degree=BP1["degree"], reps=20, check=True,
            dtype="bf16")),
        *[(f"operators_bench {op}", lambda op=op: operators_bench.run(
            op=op, s=14, degree=4, reps=20, check=True, dtype="bf16"))
          for op in ("stiffness-general", "mass-general", "mass", "stiffness-gauss")],
        ("general_solve P8", lambda: general_solve.run(s=16, degree=4, steps=200,
                                                       dtype="bf16")),
        *[(f"scatter_bench {mode}", lambda mode=mode: scatter_bench.run(
            mode=mode, size=32, degree=4, reps=20, dtype="bf16", check=True, ndev=4))
          for mode in scatter_bench.MODES],
        ("tsmm", lambda: tsmm.run(reps=20, dtype="bf16", check=True)),
    ]
    for label, fn in benches:
        zero()
        rec = fn()
        torch.cuda.synchronize()
        counts = launched()
        rec["launches"] = counts
        print(f"bench26 {label} " + json.dumps(rec))
        check(rec["dtype"] == "bf16", f"{label}: a bf16 record")
        if label.startswith("cg_bench bp1"):
            want = rec["solves"] * (1 + rec["iters"]) + 1 + rec["iters_f64"]
            check(counts == {"G": want}, f"{label}: G {want} (the bf16 solves and the "
                  "f64 reference)")
        out["bench"][label] = {k: rec.get(k) for k in (
            "iters", "iters_f64", "sol_rel_vs_f64", "ms_total", "ms_per_apply",
            "max_rel_err_vs_f64_oracle", "max_rel_err_vs_f64", "ms_per_step",
            "us_per_exchange", "ms", "vmax", "launches")}
        # the bf16 launches: the cg_bench records' f64 reference solve takes
        # 1 + iters_f64 of them in f64
        f64_ref = 1 + rec["iters_f64"] if label.startswith("cg_bench") else 0
        add_launches({k: c - f64_ref for k, c in counts.items() if k in ("G", "K")})
    part_done("d")
    print(f"phase 26 {sum(out['seconds'].values()):.1f} s ("
          + ", ".join(f"{k} {s:.1f}" for k, s in out["seconds"].items()) + ")")
    return out


def main() -> None:
    import numpy as np
    import torch

    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is False")
    if not (ROOT / "wave_fenics_tpu_torch" / "csrc").is_dir():
        raise RuntimeError(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # the plain versions are references: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from wave_fenics_tpu_torch import native
    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.benchmarks import cg_bench, general_solve, operators_bench
    from wave_fenics_tpu_torch.convert import tables_from_numpy
    from wave_fenics_tpu_torch.core.basis import gll_points_weights
    from wave_fenics_tpu_torch.core.dofmap import StructuredDofGrid, build_dofmap
    from wave_fenics_tpu_torch.core.io import (
        read_xdmf,
        read_xdmf_attributes,
        read_xdmf_geometry,
        write_xdmf_mesh,
        write_xdmf_meshtags,
    )
    from wave_fenics_tpu_torch.core.mesh import FacetTags, HexMesh, box_mesh
    from wave_fenics_tpu_torch.models import diagnostics, general_wave, linear_wave
    from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
    from wave_fenics_tpu_torch.models.linear_wave import LinearWave
    from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
    from wave_fenics_tpu_torch.models.planar3d import (
        analytic_plane_wave,
        planar3d_case,
    )
    from wave_fenics_tpu_torch.ops import (
        _cuda,
        general,
        lf2step,
        lfstep,
        mass,
        rk4step,
        rk42step,
        stiffness,
        wave,
    )
    from wave_fenics_tpu_torch.ops.assembled import (
        EAOperator,
        assemble_csr,
        assemble_element_tensors,
        csr_tensor,
    )
    from wave_fenics_tpu_torch.ops.operators import GeneralOperators, StructuredOperators
    from wave_fenics_tpu_torch.ops.separable import separable_mass_tables
    from wave_fenics_tpu_torch.solvers.cg import cg
    from wave_fenics_tpu_torch.solvers.newmark import newmark_solve_n
    from wave_fenics_tpu_torch.solvers.rk4 import rk4_solve_n
    from wave_fenics_tpu_torch.utils.config import SimulationConfig
    from wave_fenics_tpu_torch.utils.timing import Timer, timeit

    # the launch counters, one per kernel
    counters = {
        "A": rk4step.rk4_step_lean_cuda, "B": wave.apply_flat_cuda,
        "C": rk4step.rk4_step_full_cuda, "D": wave.rk_stage_cuda,
        "H": lfstep.lf_step_cuda, "I": lf2step.lf2_step_cuda,
        "F": stiffness.stiffness_grid_cuda, "G": mass.mass_apply_cuda,
        "K": general.general_apply_cuda, "E": wave.apply_slab_cuda,
        "J": rk42step.rk42_step_cuda,
    }

    # the set-up kernels' counters (native.py), read apart from the solvers'
    setup_counters = {"geometry": native.geometry_factors_cuda,
                      "keys": native.node_keys_cuda, "dedup": native.dedup_dofs_cuda}

    def zero_counts():
        for fn in (*counters.values(), *setup_counters.values()):
            fn.launches = 0

    def read_setup():
        return {k: fn.launches for k, fn in setup_counters.items()}

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    kl = _cuda.library()
    print(f"built {kl.path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_seconds:.2f} s)")
    for line in kl.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    def small_model(p, dtype=torch.float64, lean=True, tile_x=16, cells=(4, 2, 2),
                    kernel="flat"):
        mesh = box_mesh(cells, (0.01, 0.005, 0.005),
                        facet_tags=FacetTags({1: (0,), 2: (1,)}))
        return PaddedLinearWave(LinearWave(mesh, p=p, dtype=dtype, device=dev),
                                tile_x=tile_x, lean=lean, kernel=kernel)

    def random_padded(layout, seed, dtype, scale=1.0):
        x = np.zeros(layout.padded_shape)
        x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(
            layout.shape)
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def random_state(pm, seed):
        """A random (u, v) with zero padding, v scaled by 1e3 as in
        tests/test_torch_gpu.py: every row, the absorbing row abc_x
        included, carries O(max|v|) values from the first step on, so the
        face terms of every kernel are exercised."""
        dtype = pm.base.dtype
        return (random_padded(pm.layout, seed, dtype),
                random_padded(pm.layout, seed + 1, dtype, scale=1e3))

    def plain_solve(pm, kind, dt, nsteps, u0, v0):
        """The model solver of ``kind`` ('lean', 'full', 'fused', 'lf',
        'lf2', 'rk42') on the plain versions, on the card, from (u0, v0)."""
        u, v = u0, v0
        t, b = 0.0, pm.base
        g, lay, c0 = b.g_amplitude, pm.layout, b.c0
        if kind == "rk42":
            for _ in range(nsteps // 2):
                u, v = rk42step.rk42_step_plain(
                    u, v, dt, [g(t + j * 0.5 * dt) for j in range(5)], lay, c0,
                    pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
                t = t + 2 * dt
            if nsteps % 2:
                step = (rk4step.rk4_step_lean_plain if pm.lean
                        else rk4step.rk4_step_full_plain)
                u, v = step(u, v, dt, [g(t + c * dt) for c in RK_C], lay, c0,
                            pm.step_tables)
            return u, v
        n = nsteps // 2 if kind == "lf2" else nsteps
        for _ in range(n):
            if kind in ("lean", "full"):
                step = (rk4step.rk4_step_lean_plain if kind == "lean"
                        else rk4step.rk4_step_full_plain)
                u, v = step(u, v, dt, [g(t + c * dt) for c in RK_C], lay, c0,
                            pm.step_tables)
            elif kind == "fused":
                ku, kv, ua, va = u, v, u, v
                for j in range(4):
                    ku, kv, ua, va = wave.rk_stage_plain(
                        u, ku, v, kv, ua, va, dt * RK_A[j], dt * RK_B[j],
                        g(t + RK_C[j] * dt), lay, c0, pm.flat_tables,
                        pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
                u, v = ua, va
            elif kind == "lf":
                u, v = lfstep.lf_step_plain(u, v, dt, g(t), g(t + dt), lay, c0,
                                            pm.lf_tables)
            else:
                u, v = lf2step.lf2_step_plain(u, v, dt, g(t), g(t + dt),
                                              g(t + 2 * dt), lay, c0,
                                              pm.lf2_tables)
            t = t + 2 * dt if kind == "lf2" else t + dt
        if kind == "lf2" and nsteps % 2:
            u, v = lfstep.lf_step_plain(u, v, dt, g(t), g(t + dt), lay, c0,
                                        pm.lf_tables)
        return u, v

    def kernel_solve(pm, kind, dt, nsteps, u0, v0):
        solve = {"lean": pm.solve_step_n, "full": pm.solve_step_n,
                 "fused": pm.solve_fused_n, "lf": pm.solve_lf_n,
                 "lf2": pm.solve_lf2_n, "rk42": pm.solve_step2_n}[kind]
        u, v, _ = solve(0.0, dt, nsteps, u0, v0)
        return u, v

    def field_bytes(pm):
        return math.prod(pm.layout.padded_shape) * torch.finfo(pm.base.dtype).bits // 8

    def table_bytes(pm):
        """Bytes of the stencil tables and facet planes the kernels read."""
        return sum(t.numel() * t.element_size()
                   for t in (*pm.stencil, pm.face_w1, pm.face_w2))

    def interior_bytes(pm):
        return math.prod(pm.layout.shape) * torch.finfo(pm.base.dtype).bits // 8

    def bound(pm, ins, outs, applies, pointwise_flops):
        """(bound_ms, bound_by): the larger of the compulsory bytes over the
        HBM rate and the flops on the interior points over the f32 peak.
        The compulsory bytes, by the rule every bound of this script uses:
        each input field's interior read once (its padding is 0 by the
        layout's invariant, so no result depends on it), each output field
        written once on its whole padded box (0 in the padding), plus the
        tables. One stencil apply is 6K + 2 flops a point (K = 2p + 1;
        csrc/stencil.cuh: K x taps, 2K - 1 y/z taps, 2 FMA flops each, the
        merged shift-0 tap's add and the two line products and their
        sum)."""
        K = 2 * pm.layout.p + 1
        nbytes = ins * interior_bytes(pm) + outs * field_bytes(pm) + table_bytes(pm)
        flops = math.prod(pm.layout.shape) * (applies * (6 * K + 2) + pointwise_flops)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def state_err(uk, vk, up, vp):
        """(max|error| over u and v, the larger of |du|/max|u_ref| and
        |dv|/max|v_ref|)."""
        umax, vmax = float(up.abs().max()), float(vp.abs().max())
        check(umax > 0 and vmax > 0, "a nonzero reference state")
        du = float((uk - up).abs().max())
        dv = float((vk - vp).abs().max())
        return max(du, dv), max(du / umax, dv / vmax)

    def padding_zero(layout, *xs):
        for x in xs:
            outside = x.clone()
            outside[layout.interior] = 0.0
            check(float(outside.abs().max()) == 0.0, "the padding stays zero")

    def nan_workspace(pm):
        """Fill the model's kernel buffers (the ping-pong state pairs and
        the scratch) with NaN, so a step kernel that leaves a point
        unwritten shows it."""
        pairs, scratch = pm._workspace()
        for x in (*pairs[0], *pairs[1], *scratch):
            x.fill_(float("nan"))

    def workspace_clean(pm, nscratch=3):
        """The state pairs and the first ``nscratch`` scratch fields a step
        kernel wrote: exactly zero padding and no NaN."""
        pairs, scratch = pm._workspace()
        xs = (*pairs[0], *pairs[1], *scratch[:nscratch])
        padding_zero(pm.layout, *xs)
        check(all(bool(torch.isfinite(x).all()) for x in xs), "no NaN left")

    def stage_us(launcher, pm, u, v, dt, gs, bufs):
        """Microseconds of each of the four stage launches of kernel A or C
        (``launcher``) at ``pm``'s size: CUDA events over back-to-back
        launches with their arguments converted once, so the host's
        per-call checks do not pace them."""
        out = []
        for j in range(4):
            args = rk4step.stage_launch_args(
                j, u, v, *bufs[2:], bufs[2 + j] if j < 3 else bufs[4], *bufs[:2],
                pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x, dt, gs[j], pm.base.c0,
                pm.layout, pm.stencil)
            out.append(1e6 * timeit(_cuda.launcher(_cuda.library(), launcher, u.dtype,
                                                   dev, *args), reps=200))
        return out

    # -- 3. kernel B --------------------------------------------------------
    phase("kernel B (tiled TMA apply_flat) against apply_flat_plain")
    # every p the kernel takes, on (4,2,2) cells and on (5,3,3), ragged
    # against the tiling, each from an output full of NaN; also against the
    # plain twin in the kernel's sum order (apply_stencil_plain)
    for p in range(1, 9):
        for cells in ((4, 2, 2), (5, 3, 3)):
            pm = small_model(p, cells=cells)
            x = random_padded(pm.layout, 1 + p, torch.float64)
            yk = wave.apply_flat_cuda(x, pm.layout, pm.stencil,
                                      out=torch.full_like(x, float("nan")))
            yp = wave.apply_flat_plain(x, pm.layout, pm.flat_tables)
            ys = wave.apply_stencil_plain(x, pm.layout, pm.stencil)
            torch.cuda.synchronize()
            rel = float((yk - yp).abs().max() / yp.abs().max())
            rel_s = float((yk - ys).abs().max() / ys.abs().max())
            print(f"f64 {cells} p={p}, padded {pm.layout.padded_shape}, from NaN: "
                  f"max|err|/max|ref| = {rel:.3e}, against the twin in the kernel's "
                  f"order {rel_s:.3e} (limit 1e-12)")
            check(rel <= 1e-12 and rel_s <= 1e-12, f"kernel B f64 p={p} {cells}")
            padding_zero(pm.layout, yk)

    case, hpm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    n_rk4 = case.nsteps
    print(f"headline: {case.model.ops.ndofs} dofs, padded "
          f"{hpm.layout.padded_shape}, tile_x {hpm.layout.tile_x}, "
          f"{case.nsteps} steps")
    x = random_padded(hpm.layout, 2, torch.float32)
    yk = wave.apply_flat_cuda(x, hpm.layout, hpm.stencil,
                              out=torch.full_like(x, float("nan")))
    yp = wave.apply_flat_plain(x, hpm.layout, hpm.flat_tables)
    torch.cuda.synchronize()
    b_err = float((yk - yp).abs().max())
    rel = b_err / float(yp.abs().max())
    print(f"f32 headline, from NaN: max|err| = {b_err:.6e}, max|err|/max|ref| = "
          f"{rel:.3e} (limit 1e-5)")
    check(rel <= 1e-5, "kernel B f32 agreement")
    padding_zero(hpm.layout, yk)
    out_b = torch.empty_like(x)
    b_wrapper_ms = 1e3 * timeit(
        lambda: wave.apply_flat_cuda(x, hpm.layout, hpm.stencil, out=out_b))
    b_args = wave.flat_launch_args(x, out_b, hpm.layout, hpm.stencil)
    b_ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_apply_flat_tiled", x.dtype,
                                       dev, *b_args), reps=200)
    b_plain_ms = 1e3 * timeit(
        lambda: wave.apply_flat_plain(x, hpm.layout, hpm.flat_tables), reps=5)
    b_bound = bound(hpm, 1, 1, 1, 0)
    print(f"f32 headline (tiles {b_args[-7]}x{b_args[-6]}, x-chunks of {b_args[-5]}, "
          f"grid {tuple(b_args[-4:-1])}, {b_args[-1]} B shared): kernel {b_ms:.4f} "
          f"ms/apply (through the wrapper {b_wrapper_ms:.4f}), plain {b_plain_ms:.4f} "
          f"ms/apply, bound {b_bound[0]:.4f} ms ({b_bound[1]}) [{smi}]")
    del x, yk, yp, out_b

    # -- 4. kernel A --------------------------------------------------------
    phase("kernel A (tiled rk4 stage kernel) against rk4_step_lean_plain")
    # every kernel-versus-plain check starts from a random state (see
    # random_state) and from NaN in every kernel buffer; the relative error
    # is per field: |du|/max|u_ref| and |dv|/max|v_ref|, the larger of the two
    for p, cells in ((1, (4, 2, 2)), (2, (4, 2, 2)), (3, (4, 2, 2)), (4, (4, 2, 2)),
                     (4, (9, 4, 8))):
        spm = small_model(p, cells=cells, tile_x=max(16, rk4step._off0(p)))
        grid, ty, tz, cx, _ = rk4step.stage_geometry(spm.face_w1, spm.layout, 3)[:5]
        nan_workspace(spm)
        u0, v0 = random_state(spm, 10 * p)
        uk, vk = kernel_solve(spm, "lean", 1e-9, 25, u0, v0)
        up, vp = plain_solve(spm, "lean", 1e-9, 25, u0, v0)
        torch.cuda.synchronize()
        _, rel = state_err(uk, vk, up, vp)
        print(f"f64 {cells} p={p} (interior {spm.layout.shape}, tiles {ty}x{tz}, "
              f"x-chunks of {cx}, grid {grid}), 25 steps from a random state and "
              f"NaN buffers: relative error {rel:.3e} (limit 1e-12)")
        check(rel <= 1e-12, f"kernel A f64 p={p} {cells}")
        workspace_clean(spm)

    nan_workspace(hpm)
    u0, v0 = random_state(hpm, 3)
    uk, vk = kernel_solve(hpm, "lean", case.dt, 50, u0, v0)
    up, vp = plain_solve(hpm, "lean", case.dt, 50, u0, v0)
    torch.cuda.synchronize()
    a_err, rel = state_err(uk, vk, up, vp)
    print(f"f32 headline, 50 steps from a random state and NaN buffers: max|err| "
          f"= {a_err:.6e}, relative {rel:.3e} (limit 1e-4)")
    check(rel <= 1e-4, "kernel A f32 agreement")
    workspace_clean(hpm)
    gs = [hpm.base.g_amplitude(c * case.dt) for c in RK_C]
    bufs = [torch.empty_like(uk) for _ in range(5)]
    a_ms = 1e3 * timeit(lambda: rk4step.rk4_step_lean_cuda(
        uk, vk, case.dt, gs, hpm.layout, hpm.base.c0, hpm.stencil,
        hpm.face_w1, hpm.face_w2, hpm.src_x, hpm.abc_x,
        out=tuple(bufs[:2]), scratch=tuple(bufs[2:])))
    a_stage_us = stage_us("wave_rk4_stage", hpm, uk, vk, case.dt, gs, bufs)
    a_plain_ms = 1e3 * timeit(lambda: rk4step.rk4_step_lean_plain(
        uk, vk, case.dt, gs, hpm.layout, hpm.base.c0, hpm.step_tables), reps=5)
    # u0, v0 in and u1, v1 out once; four stencil applies and ~20 point-wise
    # flops a point
    a_bound = bound(hpm, 2, 2, 4, 20)
    # what four launches must move, by bound's rule (inputs' interiors,
    # padded outputs): J0 u0 -> kv0, J1 u0, v0 -> kv1, J2 u0, v0, kv0 ->
    # kv2, J3 u0, v0, kv0, kv1, kv2 -> u1, v1: 11 fields in, 5 out
    floor_ms = 1e3 * (11 * interior_bytes(hpm) + 5 * field_bytes(hpm)) / HBM_BYTES_PER_S
    grid, ty, tz, cx, smem = rk4step.stage_geometry(bufs[0], hpm.layout, 3)[:5]
    print(f"f32 headline (tiles {ty}x{tz}, x-chunks of {cx}, grid {grid}, "
          f"{smem} B shared in stage 3): kernel {sum(a_stage_us) / 1e3:.4f} ms/step "
          f"({rk4step.LAUNCHES_PER_STEP} launches: stages "
          f"{', '.join(f'{t:.2f}' for t in a_stage_us)} us; through the wrapper "
          f"{a_ms:.4f} ms/step), plain {a_plain_ms:.4f} "
          f"ms/step, bound {a_bound[0]:.4f} ms ({a_bound[1]}), 4-launch floor "
          f"{floor_ms:.4f} ms (11 fields in, 5 out) [{smi}]")
    del u0, v0, uk, vk, up, vp, bufs, hpm

    # -- 5. kernels C, D, H, I ----------------------------------------------
    results = {}  # kernel -> (max_abs_err, ms, plain_ms, (bound_ms, bound_by))

    # the kernel buffers each solver writes: (pairs, first scratch fields)
    nscratch = {"full": 3, "lf": 1, "lf2": 3, "rk42": 6}

    def check_small(name, kind, ps, tol=1e-12, **model_kw):
        for p in ps:
            kw = dict(model_kw)
            if kind in ("lf", "lf2"):  # kernel I's 3p-deep halo: tile 24 from p = 6
                kw.setdefault("tile_x", max(16, lf2step._off0(p)))
            if kind == "rk42":  # kernel J's 6p-deep halo: tile 24, 32 from p = 5
                kw["tile_x"] = max(kw.get("tile_x", 16), rk42step._off0(p))
            spm = small_model(p, **kw)
            if kind in nscratch:  # kernels C, H, I from NaN in every buffer, as A
                nan_workspace(spm)
            u0, v0 = random_state(spm, 10 * p)
            uk, vk = kernel_solve(spm, kind, 1e-9, 25, u0, v0)
            up, vp = plain_solve(spm, kind, 1e-9, 25, u0, v0)
            torch.cuda.synchronize()
            _, rel = state_err(uk, vk, up, vp)
            print(f"kernel {name} f64 (4,2,2) p={p}, 25 steps from a random "
                  f"state: relative error {rel:.3e} (limit {tol:.0e})")
            check(rel <= tol, f"kernel {name} f64 p={p}")
            padding_zero(spm.layout, uk, vk)
            if kind in nscratch:
                workspace_clean(spm, nscratch[kind])
            if name == "C":  # the same step in the lean algebra (kernel A)
                ul, vl = kernel_solve(small_model(p), "lean", 1e-9, 25, u0, v0)
                _, rel = state_err(uk, vk, ul, vl)
                print(f"kernel C vs kernel A f64 p={p}: relative error "
                      f"{rel:.3e} (limit 1e-13)")
                check(rel <= 1e-13, f"kernel C vs kernel A p={p}")
            if name == "J":  # the same steps, one step per call of kernel C
                uc, vc = kernel_solve(small_model(p, **kw), "full", 1e-9, 25, u0, v0)
                _, rel = state_err(uk, vk, uc, vc)
                print(f"kernel J vs kernel C f64 p={p}: relative error "
                      f"{rel:.3e} (limit 1e-13)")
                check(rel <= 1e-13, f"kernel J vs kernel C p={p}")

    def check_full_width(name, kind, pm, dt):
        u0, v0 = random_state(pm, 5)
        uk, vk = kernel_solve(pm, kind, dt, 50, u0, v0)
        up, vp = plain_solve(pm, kind, dt, 50, u0, v0)
        torch.cuda.synchronize()
        err, rel = state_err(uk, vk, up, vp)
        print(f"kernel {name} f32 {pm.layout.padded_shape} p={pm.layout.p}, 50 "
              f"steps from a random state: max|err| = {err:.6e}, relative "
              f"{rel:.3e} (limit 1e-4)")
        check(rel <= 1e-4, f"kernel {name} f32 agreement")
        padding_zero(pm.layout, uk, vk)
        return err, uk, vk

    phase("kernel C (full-tableau tiled rk4 stage kernel) against rk4_step_full_plain")
    check_small("C", "full", (2, 4), lean=False)
    case, cpm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda", lean=False)
    nan_workspace(cpm)
    c_err, uk, vk = check_full_width("C", "full", cpm, case.dt)
    workspace_clean(cpm)
    gs = [cpm.base.g_amplitude(c * case.dt) for c in RK_C]
    bufs = [torch.empty_like(uk) for _ in range(5)]
    c_ms = 1e3 * timeit(lambda: rk4step.rk4_step_full_cuda(
        uk, vk, case.dt, gs, cpm.layout, cpm.base.c0, cpm.stencil,
        cpm.face_w1, cpm.face_w2, cpm.src_x, cpm.abc_x,
        out=tuple(bufs[:2]), scratch=tuple(bufs[2:])))
    c_stage_us = stage_us("wave_rk4_full_stage", cpm, uk, vk, case.dt, gs, bufs)
    print(f"kernel C f32 headline: stages {', '.join(f'{t:.2f}' for t in c_stage_us)} "
          f"us, {sum(c_stage_us) / 1e3:.4f} ms/step against kernel A "
          f"{sum(a_stage_us) / 1e3:.4f} (through the wrappers {c_ms:.4f} and "
          f"{a_ms:.4f}) [{smi}]")
    c_plain_ms = 1e3 * timeit(lambda: rk4step.rk4_step_full_plain(
        uk, vk, case.dt, gs, cpm.layout, cpm.base.c0, cpm.step_tables), reps=5)
    # the kernel's time per step: its four stage launches back to back
    results["C"] = (c_err, sum(c_stage_us) / 1e3, c_plain_ms, bound(cpm, 2, 2, 4, 30))
    del uk, vk, bufs, cpm

    phase("kernel D (tiled TMA rk stage kernel) against rk_stage_plain")
    check_small("D", "fused", (2, 4, 8))
    # one stage on (5,3,3) cells (ragged against the tiling), from inputs
    # random in the padding too and outputs full of NaN, out of place and
    # with ua'/va' written over ua/va as solve_fused_n does: kv' exactly 0
    # and va' exactly va in the padding
    for p in (2, 4, 8):
        spm = small_model(p, cells=(5, 3, 3))
        rng = np.random.default_rng(60 + p)
        ins = [torch.as_tensor(sc * rng.standard_normal(spm.layout.padded_shape),
                               device=dev) for sc in (1.0, 1e3, 1e3, 1e9, 1.0, 1e3)]
        sargs = (0.5e-9, 1e-9 / 3.0, 0.7, spm.layout, spm.base.c0)
        sface = (spm.face_w1, spm.face_w2, spm.src_x, spm.abc_x)
        want = wave.rk_stage_plain(*ins, *sargs, spm.flat_tables, *sface)
        pad = torch.ones(spm.layout.padded_shape, dtype=torch.bool, device=dev)
        pad[spm.layout.interior] = False
        for in_place in (False, True):
            ua, va = ins[4].clone(), ins[5].clone()
            nan = [torch.full_like(ua, float("nan")) for _ in range(4)]
            out = (*nan[:2], ua, va) if in_place else tuple(nan)
            got = wave.rk_stage_cuda(*ins[:4], ua, va, *sargs, spm.stencil, *sface,
                                     out=out)
            torch.cuda.synchronize()
            rel = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            print(f"kernel D f64 (5,3,3) p={p}, one stage from NaN buffers"
                  f"{', ua/va in place' if in_place else ''}: relative error "
                  f"{rel:.3e} (limit 1e-12)")
            check(rel <= 1e-12 and all(bool(torch.isfinite(g).all()) for g in got),
                  f"kernel D f64 p={p} in_place={in_place}")
            check(float(got[1][pad].abs().max()) == 0.0
                  and torch.equal(got[3][pad], ins[5][pad]),
                  f"kernel D padding p={p}: kv' = 0 and va' = va")
    case8, dpm = planar3d_app.build(**HEADLINE_P8, dtype="f32", device="cuda")
    print(f"p=8: {case8.model.ops.ndofs} dofs, padded {dpm.layout.padded_shape}, "
          f"tile_x {dpm.layout.tile_x}, {case8.nsteps} RK4 steps; step kernel: "
          f"{dpm.step_unavailable}")
    nan_workspace(dpm)
    d_err, uk, vk = check_full_width("D", "fused", dpm, case8.dt)
    workspace_clean(dpm, nscratch=4)
    # six distinct inputs, as stages 1-3 of solve_fused_n give them
    # (u0, ku = the last stage's vn, v0, kv, ua, va), so that the bound's
    # six inputs count only bytes this call must move
    ins = tuple(x.clone() for x in (uk, uk, vk, vk, uk, vk))
    dargs = (0.5 * case8.dt, case8.dt / 3.0, 1.0, dpm.layout, dpm.base.c0)
    face = (dpm.face_w1, dpm.face_w2, dpm.src_x, dpm.abc_x)
    bufs = tuple(torch.empty_like(uk) for _ in range(4))
    d_wrapper_ms = 1e3 * timeit(lambda: wave.rk_stage_cuda(
        *ins, *dargs, dpm.stencil, *face, out=bufs))
    d_args = wave.rk_stage_launch_args(*ins, *bufs, *dargs, dpm.stencil, *face)
    d_ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_rk_stage_tiled",
                                       uk.dtype, dev, *d_args), reps=200)
    d_plain_ms = 1e3 * timeit(lambda: wave.rk_stage_plain(
        *ins, *dargs, dpm.flat_tables, *face), reps=5)
    print(f"kernel D f32 P4 (tiles {d_args[-7]}x{d_args[-6]}, x-chunks of "
          f"{d_args[-5]}, grid {tuple(d_args[-4:-1])}, {d_args[-1]} B shared): "
          f"{d_ms:.4f} ms/launch (through the wrapper {d_wrapper_ms:.4f}) [{smi}]")
    # u0, ku, v0, kv, ua, va in and vn, kv', ua', va' out; one apply
    results["D"] = (d_err, d_ms, d_plain_ms, bound(dpm, 6, 4, 1, 8))
    del uk, vk, ins, bufs, dpm

    def phase_us(pm, phases, u, v, bufs, dt, gs):
        """Microseconds of each leapfrog phase launch (kernels H and I) at
        ``pm``'s size: CUDA events over back-to-back launches with their
        arguments converted once; u_out (not in CLOSE) and v_out distinct
        buffers."""
        out = {}
        for (name, ph), g in zip(phases, gs):
            args = lfstep.lf_launch_args(
                ph, u, v, None if ph == lfstep.LF_CLOSE else bufs[0], bufs[1], dt, g,
                pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                pm.abc_x)
            out[name] = 1e6 * timeit(_cuda.launcher(_cuda.library(), "wave_lf_phase_tiled",
                                                    u.dtype, dev, *args), reps=200)
        return out

    phase("kernel H (tiled TMA leapfrog phases OPEN, CLOSE) against lf_step_plain")
    check_small("H", "lf", range(1, 9))
    _, lpm = planar3d_app.build(**HEADLINE_P8, dtype="f32", device="cuda")
    nan_workspace(lpm)
    h_err, uk, vk = check_full_width("H", "lf", lpm, case8.dt * 0.71)
    workspace_clean(lpm, nscratch["lf"])
    bufs = [torch.empty_like(uk) for _ in range(3)]
    largs = (case8.dt * 0.71, 1.0, 0.5, lpm.layout, lpm.base.c0)
    h_wrapper_ms = 1e3 * timeit(lambda: lfstep.lf_step_cuda(
        uk, vk, *largs, lpm.stencil, lpm.face_w1, lpm.face_w2, lpm.src_x,
        lpm.abc_x, out=tuple(bufs[:2]), scratch=bufs[2]))
    h_phase_us = phase_us(lpm, (("OPEN", lfstep.LF_OPEN), ("CLOSE", lfstep.LF_CLOSE)),
                          uk, vk, bufs, case8.dt * 0.71, (1.0, 0.5))
    h_plain_ms = 1e3 * timeit(lambda: lfstep.lf_step_plain(
        uk, vk, *largs, lpm.lf_tables), reps=5)
    print(f"kernel H f32 P3: phases {h_phase_us} us, {sum(h_phase_us.values()) / 1e3:.4f} "
          f"ms/step (through the wrapper {h_wrapper_ms:.4f}) [{smi}]")
    results["H"] = (h_err, sum(h_phase_us.values()) / 1e3, h_plain_ms,
                    bound(lpm, 2, 2, 2, 12))
    del uk, vk, bufs, lpm

    phase("kernel I (tiled TMA leapfrog phases OPEN, MID, CLOSE) against lf2_step_plain")
    check_small("I", "lf2", range(1, 9))
    case, ipm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    nan_workspace(ipm)
    i_err, uk, vk = check_full_width("I", "lf2", ipm, case.dt * 0.71)
    workspace_clean(ipm, nscratch["lf2"])
    bufs = [torch.empty_like(uk) for _ in range(5)]
    iargs = (case.dt * 0.71, 1.0, 0.5, 0.2, ipm.layout, ipm.base.c0)
    i_wrapper_ms = 1e3 * timeit(lambda: lf2step.lf2_step_cuda(
        uk, vk, *iargs, ipm.stencil, ipm.face_w1, ipm.face_w2, ipm.src_x,
        ipm.abc_x, out=tuple(bufs[:2]), scratch=tuple(bufs[2:])))
    i_phase_us = phase_us(ipm, (("OPEN", lfstep.LF_OPEN), ("MID", lfstep.LF_MID),
                                ("CLOSE", lfstep.LF_CLOSE)),
                          uk, vk, bufs, case.dt * 0.71, (1.0, 0.5, 0.2))
    i_plain_ms = 1e3 * timeit(lambda: lf2step.lf2_step_plain(
        uk, vk, *iargs, ipm.lf2_tables), reps=5)
    print(f"kernel I f32 P2: phases {i_phase_us} us, {sum(i_phase_us.values()) / 1e3:.4f} "
          f"ms per 2 steps (through the wrapper {i_wrapper_ms:.4f}) [{smi}]")
    results["I"] = (i_err, sum(i_phase_us.values()) / 1e3, i_plain_ms,
                    bound(ipm, 2, 2, 3, 24))
    del uk, vk, bufs, ipm
    for k, unit in (("C", "step"), ("D", "stage launch"), ("H", "step"),
                    ("I", "call of 2 steps")):
        err, ms, plain_ms, (bms, by) = results[k]
        print(f"kernel {k}: {ms:.4f} ms/{unit}, plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{smi}]")

    # -- 6. kernels F and G -------------------------------------------------
    def op_bound(nbytes, flops):
        """(bound_ms, bound_by): the bytes over the HBM rate against the
        flops over the f32 peak."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def rel_err(yk, yp):
        err = float((yk - yp).abs().max())
        return err, err / float(yp.abs().max())

    def grid_tables(ops):
        return stiffness.GridStiffnessTables(*tables_from_numpy(
            stiffness.stiffness_grid_tables(ops._sepA, ops._seplines,
                                            ops.grid_shape, ops.p, -1500.0**2,
                                            ops.dtype), dev, ops.dtype))

    def random_grid(shape, seed, dtype):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                               dtype=dtype, device=dev)

    phase("kernel F (tiled cp.async stiffness_grid) against stiffness_grid_plain")
    # every p StructuredOperators takes, on (4,2,3) cells (Nx = 17 at p=4,
    # the JAX tests' ragged grid) and on (5,3,4), ragged against the tiling,
    # each from an output full of NaN
    for p in range(1, 11):
        for cells in ((4, 2, 3), (5, 3, 4)):
            ops = StructuredOperators(box_mesh(cells, (1.0, 0.8, 1.2)), p,
                                      dtype=torch.float64)
            tabs = grid_tables(ops)
            x = random_grid(ops.grid_shape, 20 + p, torch.float64)
            yk = stiffness.stiffness_grid_cuda(x, tabs, p,
                                               out=torch.full_like(x, float("nan")))
            yp = stiffness.stiffness_grid_plain(x, tabs, p)
            torch.cuda.synchronize()
            _, rel = rel_err(yk, yp)
            print(f"f64 {cells} p={p}, grid {ops.grid_shape}, from NaN: "
                  f"max|err|/max|ref| = {rel:.3e} (limit 1e-12)")
            check(rel <= 1e-12 and bool(torch.isfinite(yk).all()),
                  f"kernel F f64 p={p} {cells}")
    fops = StructuredOperators(box_mesh((BP1["size"],) * 3, (1.0, 1.0, 1.0)),
                               BP1["degree"], dtype=torch.float32)
    check(fops.ndofs == BP1_DOFS, "the BP1 size")
    ftabs = grid_tables(fops)
    x = random_grid(fops.grid_shape, 21, torch.float32)
    yk = stiffness.stiffness_grid_cuda(x, ftabs, fops.p,
                                       out=torch.full_like(x, float("nan")))
    yp = stiffness.stiffness_grid_plain(x, ftabs, fops.p)
    torch.cuda.synchronize()
    f_err, rel = rel_err(yk, yp)
    print(f"f32 {fops.grid_shape} p=4, from NaN: max|err| = {f_err:.6e}, "
          f"max|err|/max|ref| = {rel:.3e} (limit 1e-5)")
    check(rel <= 1e-5, "kernel F f32 agreement")
    out_f = torch.empty_like(x)
    f_wrapper_ms = 1e3 * timeit(
        lambda: stiffness.stiffness_grid_cuda(x, ftabs, fops.p, out=out_f))
    f_args = stiffness.stiffness_launch_args(x, out_f, ftabs, fops.p)
    f_ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_stiffness_tiled", x.dtype,
                                       dev, *f_args), reps=200)
    print(f"kernel F f32 P7 (tiles {f_args[-7]}x{f_args[-6]}, x-chunks of "
          f"{f_args[-5]}, grid {tuple(f_args[-4:-1])}, {f_args[-1]} B shared): "
          f"{f_ms:.4f} ms/apply (through the wrapper {f_wrapper_ms:.4f}) [{smi}]")
    f_plain_ms = 1e3 * timeit(lambda: stiffness.stiffness_grid_plain(x, ftabs, fops.p),
                              reps=5)
    # x in, y out; 3(2p+1) taps at 2 flops, 3 line products, 3 products, 2 adds
    results["F"] = (f_err, f_ms, f_plain_ms,
                    op_bound(2 * nbytes(x) + nbytes(*ftabs), x.numel() * (6 * 9 + 8)))
    del x, yk, yp, out_f

    phase("kernel G (tiled TMA mass_apply) against mass_apply_plain")
    # every p the kernel takes, on (3,2,2) cells and on (5,3,4), ragged
    # against the tiling, each from an output full of NaN; also against the
    # plain twin in the kernel's contraction order (z, y, x)
    for p in range(1, 9):
        for cells in ((3, 2, 2), (5, 3, 4)):
            lay, tabs, _ = mass.bp1_setup(box_mesh(cells, (1.0, 0.8, 1.2)), p,
                                          torch.float64, dev)
            x = random_padded(lay, 30 + p, torch.float64)
            yk = mass.mass_apply_cuda(x, lay, tabs, out=torch.full_like(x, float("nan")))
            yp = mass.mass_apply_plain(x, lay, tabs)
            yz = mass.mass_apply_zyx_plain(x, lay, tabs)
            torch.cuda.synchronize()
            _, rel = rel_err(yk, yp)
            _, rel_zyx = rel_err(yk, yz)
            print(f"f64 {cells} p={p}, padded {lay.padded_shape}, from NaN: "
                  f"max|err|/max|ref| = {rel:.3e}, against the z-y-x twin "
                  f"{rel_zyx:.3e} (limit 1e-12)")
            check(rel <= 1e-12 and rel_zyx <= 1e-12, f"kernel G f64 p={p} {cells}")
            padding_zero(lay, yk)
    mesh64 = box_mesh((BP1["size"],) * 3, (1.0, 1.0, 1.0))
    glay, gtabs, _ = mass.bp1_setup(mesh64, BP1["degree"], torch.float32, dev)
    x = random_padded(glay, 31, torch.float32)
    yk = mass.mass_apply_cuda(x, glay, gtabs, out=torch.full_like(x, float("nan")))
    yp = mass.mass_apply_plain(x, glay, gtabs)
    torch.cuda.synchronize()
    g_err, rel = rel_err(yk, yp)
    print(f"f32 padded {glay.padded_shape} p=4 ({nbytes(x) / 1e6:.1f} MB/field), "
          f"from NaN: max|err| = {g_err:.6e}, max|err|/max|ref| = {rel:.3e} "
          "(limit 1e-5)")
    check(rel <= 1e-5, "kernel G f32 agreement")
    padding_zero(glay, yk)
    out_g = torch.empty_like(x)
    g_wrapper_ms = 1e3 * timeit(lambda: mass.mass_apply_cuda(x, glay, gtabs, out=out_g))
    g_args = mass.mass_launch_args(x, out_g, glay, gtabs)
    g_ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_mass_tiled", x.dtype, dev,
                                       *g_args), reps=200)
    g_plain_ms = 1e3 * timeit(lambda: mass.mass_apply_plain(x, glay, gtabs), reps=5)
    print(f"kernel G f32 P7 (tiles {g_args[-7]}x{g_args[-6]}, x-chunks of "
          f"{g_args[-5]}, grid {tuple(g_args[-4:-1])}, {g_args[-1]} B shared): "
          f"{g_ms:.4f} ms/apply (through the wrapper {g_wrapper_ms:.4f}) [{smi}]")
    # by bound's rule: x's interior in, the padded y out, the tables; three
    # banded contractions of 2(2p+1) flops on each interior point
    results["G"] = (g_err, g_ms, g_plain_ms,
                    op_bound(math.prod(glay.shape) * x.element_size()
                             + nbytes(out_g, *gtabs),
                             math.prod(glay.shape) * 6 * 9))
    # the one PyTorch call that computes G's function on the P7 grid: the
    # three assembled 1D mass matrices (dense, assembled in f64 from the
    # cell blocks kernel G's tables come from) contracted with the grid by
    # torch.einsum, TF32 off; timed here, never called by the port
    M1 = separable_mass_tables(BP1["degree"], mesh64.h, np.float64)
    mats = []
    for d, n in enumerate(mesh64.shape):
        pg = BP1["degree"]
        A1 = np.zeros((n * pg + 1, n * pg + 1))
        for c in range(n):
            A1[c * pg:c * pg + pg + 1, c * pg:c * pg + pg + 1] += M1[d]
        mats.append(torch.as_tensor(A1, dtype=torch.float32, device=dev))
    xg = x[glay.interior].contiguous()
    y_lib = torch.einsum("ijk,ai,bj,ck->abc", xg, *mats)
    torch.cuda.synchronize()
    _, rel = rel_err(yk[glay.interior], y_lib)
    g_lib_ms = 1e3 * timeit(lambda: torch.einsum("ijk,ai,bj,ck->abc", xg, *mats))
    print(f"kernel G against torch.einsum of the assembled 1D masses on {tuple(xg.shape)}: "
          f"max|err|/max|ref| = {rel:.3e} (limit 1e-5); einsum {g_lib_ms:.4f} ms, "
          f"kernel G {g_ms:.4f} ms [{smi}]")
    check(rel <= 1e-5, "kernel G against the einsum of the assembled 1D masses")
    library = {"G": g_lib_ms}
    del x, yk, yp, out_g, xg, y_lib, mats
    for k in ("F", "G"):
        err, ms, plain_ms, (bms, by) = results[k]
        print(f"kernel {k}: {ms:.4f} ms/apply, plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{smi}]")

    # -- 12. kernel E -------------------------------------------------------
    phase("kernel E (tiled TMA apply_slab) against apply_slab_plain")
    # every p the kernel takes, on (3,2,3) cells (ragged against the tiling
    # at p = 4, 9, 10), and the earlier small grids; each from an output
    # buffer full of NaN
    for p, cells, kernel in ([(p, (3, 2, 3), "3d") for p in range(1, 11)]
                             + [(9, (2, 1, 1), "flat"), (10, (2, 1, 1), "flat"),
                                (10, (3, 2, 1), "flat"), (4, (4, 2, 2), "3d")]):
        spm = small_model(p, cells=cells, kernel=kernel)
        check(spm.kernel == "3d", f"p={p} {kernel}: the 3D-slab layout")
        x = random_padded(spm.layout, 90 + p, torch.float64)
        yk = wave.apply_slab_cuda(x, spm.layout, spm.slab_tables,
                                  out=torch.full_like(x, float("nan")))
        yp = wave.apply_slab_plain(x, spm.layout, spm.slab_tables)
        torch.cuda.synchronize()
        _, rel = rel_err(yk, yp)
        print(f"f64 {cells} p={p} kernel={kernel!r}, padded {spm.layout.padded_shape}, "
              f"from NaN: max|err|/max|ref| = {rel:.3e} (limit 1e-12)")
        check(rel <= 1e-12, f"kernel E f64 p={p} {kernel}")
        padding_zero(spm.layout, yk)
    case12, epm = planar3d_app.build(**P12, dtype="f32", device="cuda")
    print(f"P12 size: {case12.model.ops.ndofs} dofs, padded {epm.layout.padded_shape}, "
          f"tile_x {epm.layout.tile_x}, {case12.nsteps} RK4 steps")
    check(case12.model.ops.ndofs == P12_DOFS and epm.kernel == "3d"
          and epm.layout.padded_shape == (304, 152, 256), "the P12 model")
    x = random_padded(epm.layout, 93, torch.float32)
    yk = wave.apply_slab_cuda(x, epm.layout, epm.slab_tables,
                              out=torch.full_like(x, float("nan")))
    yp = wave.apply_slab_plain(x, epm.layout, epm.slab_tables)
    torch.cuda.synchronize()
    e_err, rel = rel_err(yk, yp)
    print(f"f32 P12 size ({nbytes(x) / 1e6:.1f} MB/field): max|err| = {e_err:.6e}, "
          f"max|err|/max|ref| = {rel:.3e} (limit 1e-5)")
    check(rel <= 1e-5, "kernel E f32 agreement")
    padding_zero(epm.layout, yk)
    out_e = torch.empty_like(x)
    e_wrapper_ms = 1e3 * timeit(lambda: wave.apply_slab_cuda(
        x, epm.layout, epm.slab_tables, out=out_e))
    e_args = wave.slab_launch_args(x, out_e, epm.layout, epm.slab_tables)
    e_ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_apply_slab_tiled",
                                       x.dtype, dev, *e_args), reps=200)
    print(f"kernel E f32 P12 (tiles {e_args[-7]}x{e_args[-6]}, x-chunks of "
          f"{e_args[-5]}, grid {tuple(e_args[-4:-1])}, {e_args[-1]} B shared): "
          f"{e_ms:.4f} ms/apply (through the wrapper {e_wrapper_ms:.4f}) [{smi}]")
    e_plain_ms = 1e3 * timeit(lambda: wave.apply_slab_plain(x, epm.layout,
                                                            epm.slab_tables), reps=5)
    # x's interior in once, the padded y out once, the tables; 3(2p+1) taps
    # at 2 flops, 3 line products and 2 adds on each interior point
    K10 = 2 * 10 + 1
    results["E"] = (e_err, e_ms, e_plain_ms,
                    op_bound(math.prod(epm.layout.shape) * x.element_size()
                             + nbytes(out_e, *epm.slab_tables),
                             math.prod(epm.layout.shape) * (6 * K10 + 5)))
    del x, yk, yp, out_e, epm

    # -- 13. kernel J -------------------------------------------------------
    phase("kernel J (2-step RK4, 7 launches) against rk42_step_plain")
    # every p the two-step path takes, on tile 24 or the 6p halo above it,
    # from NaN in every kernel buffer; lean=False puts the odd 25th step on
    # kernel C, so the comparison with kernel C's steps is like for like
    check_small("J", "rk42", range(1, 9), tile_x=24, lean=False)
    # the step boundary alone (f64, one launch from random fields into
    # outputs full of NaN) against its plain version
    for p in (2, 4, 8):
        spm = small_model(p, tile_x=max(24, rk42step._off0(p)))
        ins = [random_padded(spm.layout, 70 + p + j, torch.float64, scale=sc)
               for j, sc in enumerate((1.0, 1e3, 1e9, 1e9, 1e9))]
        bface = (spm.layout, spm.base.c0, spm.stencil, spm.face_w1, spm.face_w2,
                 spm.src_x, spm.abc_x)
        got = rk42step._rk42_boundary_cuda(
            *ins, 1e-9, 0.5, *bface,
            out=tuple(torch.full_like(ins[0], float("nan")) for _ in range(3)))
        want = rk42step.rk42_boundary_plain(*ins, 1e-9, 0.5, *bface)
        torch.cuda.synchronize()
        rel = max(rel_err(gk, wk)[1] for gk, wk in zip(got, want))
        print(f"J's step boundary alone f64 (4,2,2) p={p}, from NaN: relative error "
              f"{rel:.3e} per field (limit 1e-12)")
        check(rel <= 1e-12, f"J's step boundary f64 p={p}")
        padding_zero(spm.layout, *got)
    case, jpm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    j_err, uk, vk = check_full_width("J", "rk42", jpm, case.dt)
    gs5 = [jpm.base.g_amplitude(j * 0.5 * case.dt) for j in range(5)]
    face = (jpm.layout, jpm.base.c0, jpm.stencil, jpm.face_w1, jpm.face_w2,
            jpm.src_x, jpm.abc_x)
    bufs = [torch.empty_like(uk) for _ in range(10)]
    j_ms = 1e3 * timeit(lambda: rk42step.rk42_step_cuda(
        uk, vk, case.dt, gs5, *face, out=tuple(bufs[:2]), scratch=tuple(bufs[2:8])))

    def two_c_steps():
        a = rk4step.rk4_step_full_cuda(uk, vk, case.dt, gs5[0:2] + gs5[1:3], *face,
                                       out=tuple(bufs[:2]), scratch=tuple(bufs[2:5]))
        rk4step.rk4_step_full_cuda(*a, case.dt, gs5[2:4] + gs5[3:5], *face,
                                   out=tuple(bufs[8:10]), scratch=tuple(bufs[2:5]))

    c2_ms = 1e3 * timeit(two_c_steps)
    j_plain_ms = 1e3 * timeit(lambda: rk42step.rk42_step_plain(uk, vk, case.dt, gs5,
                                                               *face), reps=5)
    # the step boundary alone at the P1 width, on the stages a J call leaves
    # in bufs[2:5] (kv0, kv1, kv2 of (uk, vk)), into outputs full of NaN
    rk42step.rk42_step_cuda(uk, vk, case.dt, gs5, *face, out=tuple(bufs[:2]),
                            scratch=tuple(bufs[2:8]))
    bins = (uk, vk, *bufs[2:5])
    bface = (case.dt, gs5[2], *face)
    jb_out = tuple(torch.full_like(uk, float("nan")) for _ in range(3))
    got = rk42step._rk42_boundary_cuda(*bins, *bface, out=jb_out)
    want = rk42step.rk42_boundary_plain(*bins, *bface)
    torch.cuda.synchronize()
    jb_err = max(rel_err(gk, wk)[0] for gk, wk in zip(got, want))
    rel = max(rel_err(gk, wk)[1] for gk, wk in zip(got, want))
    print(f"J's step boundary alone f32 P1 width, from NaN: max|err| = {jb_err:.6e}, "
          f"relative {rel:.3e} per field (limit 1e-5)")
    check(rel <= 1e-5, "J's step boundary f32 agreement")
    padding_zero(jpm.layout, *got)
    jb_args = rk42step.boundary_launch_args(
        *bins, *jb_out, jpm.face_w1, jpm.face_w2, jpm.src_x, jpm.abc_x, case.dt, gs5[2],
        jpm.base.c0, jpm.layout, jpm.stencil)
    jb_ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_rk42_boundary_tiled",
                                        uk.dtype, dev, *jb_args), reps=200)
    jb_plain_ms = 1e3 * timeit(lambda: rk42step.rk42_boundary_plain(*bins, *bface), reps=5)
    # u0, v0, kv0, kv1, kv2 in and u1, v1, kv0' out once; two stencil
    # applies and ~30 point-wise flops a point
    results["Jb"] = (jb_err, jb_ms, jb_plain_ms, bound(jpm, 5, 3, 2, 30))
    print(f"J's step boundary f32 P1 (tiles {jb_args[-7]}x{jb_args[-6]}, x-chunks of "
          f"{jb_args[-5]}, grid {tuple(jb_args[-4:-1])}, {jb_args[-1]} B shared): "
          f"{jb_ms * 1e3:.2f} us/launch, plain {jb_plain_ms:.4f} ms, bound "
          f"{results['Jb'][3][0]:.4f} ms ({results['Jb'][3][1]}) [{smi}]")
    # u0, v0 in and u2, v2 out once; eight stencil applies (the boundary
    # launch makes two) and ~60 point-wise flops a point
    results["J"] = (j_err, j_ms, j_plain_ms, bound(jpm, 2, 2, 8, 60))
    print(f"kernel J: {j_ms:.4f} ms per 2 steps ({rk42step.LAUNCHES_PER_CALL} "
          f"launches), two kernel-C steps {c2_ms:.4f} ms (8 launches), plain "
          f"{j_plain_ms:.4f} ms, bound {results['J'][3][0]:.4f} ms "
          f"({results['J'][3][1]}) [{smi}]")
    print(f"kernel E: {e_ms:.4f} ms/apply, plain {e_plain_ms:.4f} ms, bound "
          f"{results['E'][3][0]:.4f} ms ({results['E'][3][1]}) [{smi}]")
    del uk, vk, bufs, jpm, bins, jb_out, got, want

    # -- 7. physics ---------------------------------------------------------
    phase("physics: f64 analytic plane wave through solve_step_n")
    pcase = planar3d_case(ncells=(16, 2, 2), domain_length=6.0e-3,
                          dtype=torch.float64, device=dev)
    ppm = PaddedLinearWave(pcase.model, tile_x=16)
    u, _, n = ppm.solve_step_n(pcase.t0, pcase.dt, pcase.nsteps)
    u = ppm.to_grid(u).cpu().numpy()
    m = pcase.model
    nodes, _ = gll_points_weights(m.p + 1)
    line = m.mesh.h[0] * (np.arange(m.mesh.shape[0])[:, None] + nodes[None, :])
    xs = np.concatenate([line[:, :-1].ravel(), line[-1:, -1]])
    t_end = pcase.t0 + n * pcase.dt
    u_line = u[:, 0, 0]
    u_exact = analytic_plane_wave(xs, t_end, pcase)
    rel_l2 = float(np.linalg.norm(u_line - u_exact) / np.linalg.norm(u_exact))
    spread = float(np.abs(u - u_line[:, None, None]).max() / np.abs(u).max())
    print(f"{n} steps: relative L2 = {rel_l2:.3e} (limit 1e-5), transverse "
          f"spread/max|u| = {spread:.3e} (limit 1e-6)")
    check(rel_l2 < 1e-5 and spread < 1e-6, "analytic plane wave")

    phase("physics: leapfrog order through kernel H (f64, (4,2,2), p=4)")
    spm = small_model(4)
    dt = 4e-9
    u_ref, _, _ = spm.solve_step_n(0.0, dt / 4, 256)
    scale = float(u_ref.abs().max())
    e1 = float((spm.solve_lf_n(0.0, dt / 2, 128)[0] - u_ref).abs().max()) / scale
    e2 = float((spm.solve_lf_n(0.0, dt / 4, 256)[0] - u_ref).abs().max()) / scale
    print(f"error vs RK4 at dt/4: dt/2 {e1:.4e}, dt/4 {e2:.4e}, ratio "
          f"{e1 / e2:.4f} (limits: e2 < 0.02, ratio 2.8-5.5)")
    check(e2 < 0.02 and 2.8 < e1 / e2 < 5.5, "leapfrog 2nd order")
    u0, v0 = random_state(spm, 7)
    zero_counts()
    u2, v2, _ = spm.solve_lf2_n(0.0, 1e-9, 25, u0, v0)
    odd = read_counts()
    u1, v1, _ = spm.solve_lf_n(0.0, 1e-9, 25, u0, v0)
    _, rel = state_err(u2, v2, u1, v1)
    print(f"solve_lf2_n, 25 steps: kernel I {odd['I']} launches, kernel H "
          f"{odd['H']}; against solve_lf_n from a random state: relative "
          f"error {rel:.3e} (limit 1e-13)")
    check(odd["I"] == 36 and odd["H"] == 2, f"odd-count launches {odd}")
    check(rel <= 1e-13, "solve_lf2_n against solve_lf_n")

    phase("physics: LinearWave.solve on the card (kernel F) against solve_step_n")
    spm = small_model(4)
    zero_counts()
    u_lw, v_lw, n_lw = spm.base.solve(0.0, 25 * 1e-9, 1e-9)
    lw = read_counts()
    u_st, v_st, _ = spm.solve_step_n(0.0, 1e-9, 25)
    _, rel = state_err(u_lw, v_lw, spm.to_grid(u_st), spm.to_grid(v_st))
    print(f"f64 (4,2,2) p=4, {n_lw} steps: relative error {rel:.3e} (limit "
          f"1e-12); launches {lw}")
    check(n_lw == 25 and lw["F"] == 4 * 25
          and not {k: n for k, n in lw.items() if k != "F" and n},
          f"LinearWave.solve launched {lw}, want F 100 only")
    check(rel <= 1e-12, "LinearWave.solve (kernel F) against solve_step_n")

    # -- 8. the app paths -----------------------------------------------------
    # (label, run kwargs, kernel, launches per kernel call, steps per call,
    #  what solver_path must name)
    paths = [
        ("P1 RK4, kernel A", dict(**HEADLINE), "A", 4, 1, "step kernel A"),
        ("P2 leapfrog, kernel I", dict(**HEADLINE, integrator="leapfrog"),
         "I", 3, 2, "kernel I"),
        ("P3 leapfrog p=8, kernel H", dict(**HEADLINE_P8, integrator="leapfrog"),
         "H", 2, 1, "kernel H"),
        ("P4 RK4 p=8, kernel D", dict(**HEADLINE_P8), "D", 4, 1, "kernel D"),
        ("P5 RK4 full tableau, kernel C", dict(**HEADLINE, lean=False), "C", 4, 1,
         "kernel C"),
    ]
    launches = {}
    b_on_paths = 0  # kernel B's launches over the five app runs
    apps = {}
    f32_states = {}  # the final u of P2, P3, P12, P13, P14: phase 25's reference
    for label, kw, kernel, per_call, steps_per_call, name in paths:
        phase(f"app path {label}: planar3d_app.run() at {NDOFS:,} dofs")
        zero_counts()
        out, u, _ = planar3d_app.run(**kw, dtype="f32", device="cuda", return_state=True)
        counts = read_counts()
        if label.startswith(("P2 ", "P3 ")):
            f32_states[label] = u
        del u
        print(json.dumps(out))
        launches[kernel] = counts[kernel]
        b_on_paths += counts["B"]
        apps[label] = out
        check(out["ndofs"] == NDOFS, f"{label}: ndofs")
        check(name in out["solver_path"], f"{label}: solver_path names {name}")
        check(math.isfinite(out["u_norm"]) and out["u_norm"] > 0,
              f"{label}: finite, nonzero u")
        # one warm-up kernel call before the timed solve
        calls = out["nsteps"] // steps_per_call + 1
        want = per_call * calls
        print(f"{label}: {out['nsteps']} steps, kernel {kernel} launches "
              f"{counts[kernel]} = {per_call} x ({out['nsteps'] // steps_per_call}"
              f" calls + 1 warm-up call); all counts {counts}")
        check(counts[kernel] == want, f"{label}: kernel {kernel} launched "
              f"{counts[kernel]} times, want {want}")
        others = {k: n for k, n in counts.items() if k != kernel and n}
        check(not others, f"{label}: other kernels launched {others}")
    n_rk4_p8 = case8.nsteps
    check(apps["P1 RK4, kernel A"]["nsteps"] == n_rk4 == 1489, "P1 steps")
    check(apps["P2 leapfrog, kernel I"]["nsteps"] == math.ceil(n_rk4 / 0.71) == 2098,
          "P2 steps")
    check(apps["P3 leapfrog p=8, kernel H"]["nsteps"]
          == math.ceil(n_rk4_p8 / 0.71) == 4134, "P3 steps")
    check(apps["P4 RK4 p=8, kernel D"]["nsteps"] == n_rk4_p8 == 2935, "P4 steps")
    check(apps["P5 RK4 full tableau, kernel C"]["nsteps"] == 1489, "P5 steps")
    p1, p5 = apps["P1 RK4, kernel A"], apps["P5 RK4 full tableau, kernel C"]
    rel = abs(p5["u_norm"] - p1["u_norm"]) / p1["u_norm"]
    print(f"P5 against P1 (the same RK4, two stage algebras): |u| relative "
          f"difference {rel:.3e} (limit 1e-4)")
    check(rel <= 1e-4, "full tableau agrees with the lean step")

    # kernel B's own path: the f1-path RK4 (PaddedLinearWave.solve_n) on the
    # headline model, two steps, against the step path from the same initial
    # state; counted apart from the app paths
    case, hpm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    zero_counts()
    uf, vf = hpm.solve_n(case.t0, case.dt, 2)
    f1_launches = read_counts()["B"]
    us, vs, _ = hpm.solve_step_n(case.t0, case.dt, 2)
    torch.cuda.synchronize()
    vmax = float(vs.abs().max())
    rel = float((vf - vs).abs().max()) / vmax
    print(f"f1 path vs step path, 2 steps: max|dv|/max|v| = {rel:.3e} "
          f"(limit 1e-4); kernel B launches in solve_n {f1_launches}")
    check(vmax > 0 and rel <= 1e-4, "f1 path agrees with the step path")
    check(f1_launches == 8, f"kernel B launched {f1_launches} times, want 8")

    tm = Timer(dev)
    n_hi, n_lo = 600, 150
    for n in (n_lo, n_hi):
        with tm(f"n{n}"):
            hpm.solve_step_n(case.t0, case.dt, n)
    per_step = (tm.seconds(f"n{n_hi}") - tm.seconds(f"n{n_lo}")) / (n_hi - n_lo)
    check(per_step > 0, "two-point rate")
    print(f"two-point rate ({n_hi}-{n_lo} steps): {per_step * 1e3:.4f} ms/step, "
          f"{NDOFS / per_step / 1e9:.4f} GDoF*steps/s [{smi}]")

    # -- 14. the new app paths: kernel E at p = 10, kernel J, checkpoints -----
    # (label, run kwargs, expected launches per kernel from the step count,
    #  what solver_path must name)
    new_paths = [
        ("P12 RK4 p=10, kernel E", dict(**P12), {"E": lambda n: 4 * (n + 1)},
         "kernel E"),
        ("P13 leapfrog p=10, kernel E", dict(**P12, integrator="leapfrog"),
         {"E": lambda n: (n + 1) + 2}, "kernel E"),
        ("P14 RK4 two-step, kernel J", dict(**HEADLINE, two_step=True),
         {"J": lambda n: 7 * (n // 2 + 1), "A": lambda n: 4 * (n % 2)}, "kernel J"),
    ]
    path_counts = {}
    for label, kw, want_of, name in new_paths:
        phase(f"app path {label}: planar3d_app.run()")
        zero_counts()
        out, f32_states[label], _ = planar3d_app.run(**kw, dtype="f32", device="cuda",
                                                     return_state=True)
        counts = read_counts()
        print(json.dumps(out))
        apps[label] = out
        want = {k: f(out["nsteps"]) for k, f in want_of.items()}
        print(f"{label}: {out['nsteps']} steps, launches {counts}, want {want}; "
              f"{out['solve_seconds']:.4f} s, {out['gdof_steps_per_s']:.4f} "
              f"GDoF*steps/s [{smi}]")
        check(name in out["solver_path"], f"{label}: solver_path names {name}")
        check(math.isfinite(out["u_norm"]) and out["u_norm"] > 0,
              f"{label}: finite, nonzero u")
        for k, n in want.items():
            check(counts[k] == n, f"{label}: kernel {k} launched {counts[k]}, want {n}")
        others = {k: n for k, n in counts.items() if k not in want and n}
        check(not others, f"{label}: other kernels launched {others}")
        path_counts[label] = counts
    p12, p13, p14 = (apps[label] for label, *_ in new_paths)
    launches["E"] = path_counts["P12 RK4 p=10, kernel E"]["E"]
    launches["J"] = path_counts["P14 RK4 two-step, kernel J"]["J"]
    # one step-boundary launch in each call of kernel J's seven
    launches["Jb"] = launches["J"] // rk42step.LAUNCHES_PER_CALL
    check(p12["ndofs"] == p13["ndofs"] == P12_DOFS and p14["ndofs"] == NDOFS, "ndofs")
    check(p12["nsteps"] == case12.nsteps == 3762, "P12 steps")
    check(p13["nsteps"] == math.ceil(case12.nsteps / 0.71) == 5299, "P13 steps")
    check(p14["nsteps"] == 1489 and launches["J"] == 5215 and launches["Jb"] == 745,
          "P14 steps and launches")
    rel = abs(p14["u_norm"] - p1["u_norm"]) / p1["u_norm"]
    print(f"P14 against P1 (the same RK4, two steps per call): |u| relative "
          f"difference {rel:.3e} (limit 1e-4)")
    check(rel <= 1e-4, "the two-step path agrees with the step path")

    phase("P15 the P1 configuration through --config and --checkpoint-dir")
    with tempfile.TemporaryDirectory(prefix="_p15_", dir=ROOT) as tmp:
        cfg = SimulationConfig()
        cfg.run.checkpoint_every_steps = 100
        cfg_path = os.path.join(tmp, "p1.json")
        Path(cfg_path).write_text(cfg.to_json())
        ckpt = os.path.join(tmp, "ckpt")
        argv = ["--config", cfg_path, "--checkpoint-dir", ckpt, "--steps", "300"]
        p15 = []
        for call in (1, 2):
            cfg_c, kw = planar3d_app.parse_args(argv)
            zero_counts()
            out, u, v = planar3d_app.run(cfg_c, **kw, return_state=True)
            counts = read_counts()
            print(json.dumps(out))
            ran = out["nsteps"] - out["resumed_from_step"]
            print(f"P15 call {call}: resumed from step {out['resumed_from_step']}, "
                  f"{ran} steps, snapshots {sorted(os.listdir(ckpt))}, launches {counts}")
            check(out["nsteps"] == 300 and out["resumed_from_step"] == (0, 200)[call - 1],
                  f"P15 call {call}: resumed from {out['resumed_from_step']}")
            check(sorted(os.listdir(ckpt)) == ["step_000000100.npz", "step_000000200.npz"],
                  f"P15 call {call}: snapshots at 100 and 200")
            check(counts["A"] == 4 * (ran + 1)
                  and not {k: n for k, n in counts.items() if k != "A" and n},
                  f"P15 call {call}: launches {counts}")
            p15.append((u, v))
        _, ur, vr = planar3d_app.run(SimulationConfig(), steps=300, return_state=True)
        for call, (u, v) in enumerate(p15, 1):
            _, rel = state_err(u, v, ur, vr)
            print(f"P15 call {call} against one unchunked 300-step run: relative "
                  f"error {rel:.3e} (limit 1e-5)")
            check(rel <= 1e-5, f"P15 call {call} against the unchunked run")
    del p15, ur, vr

    # -- 17. the distributed structured box (parallel/) ---------------------
    # P20: the sharded structured run at the P1 width (and at P12's p = 10
    # for kernel E), every block on this card; each path counted alone
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave
    from wave_fenics_tpu_torch.parallel.sharded_wave import ShardedLinearWave

    def x_neighbours(sw):
        """(lower, upper) block pairs along x and along y."""
        out = []
        for b in range(sw.mesh.nblocks):
            for axis in (0, 1):
                nb = sw.mesh.neighbour(b, axis, +1)
                if nb is not None:
                    out.append((axis, b, nb))
        return out

    def planes_bitwise(sw, v, lay, label):
        """Both copies of every shared x and y plane bitwise equal."""
        inter = lay.interior
        for axis, b, nb in x_neighbours(sw):
            lo = v[b][inter].select(axis, -1)
            hi = v[nb][inter].select(axis, 0)
            check(torch.equal(lo, hi), f"{label}: blocks {b} and {nb} hold one "
                  f"shared plane along axis {axis}")

    def sharded_solvers(sw, pm, kind):
        lay = sw.layout if kind == "n" else sw.halo_layout(kind)
        solve = {"n": sw.solve_n, "step": sw.solve_step_n, "lf": sw.solve_lf_n,
                 "lf2": sw.solve_lf2_n, "step2": sw.solve_step2_n}[kind]
        ref = {"n": pm.solve_n, "step": pm.solve_step_n, "lf": pm.solve_lf_n,
               "lf2": pm.solve_lf2_n, "step2": pm.solve_step2_n}[kind]
        return lay, solve, ref

    phase("P20 sharded solves, f64 at (8,4,4) cells against one device")
    for kind, parts, kernel in (("step", (2, 2, 1), "flat"), ("lf", (2, 2, 1), "flat"),
                                ("lf2", (2, 2, 1), "flat"), ("n", (2, 2, 1), "flat"),
                                ("n", (2, 1, 1), "3d")):
        m64 = LinearWave(box_mesh((8, 4, 4), (0.01, 0.005, 0.005),
                                  facet_tags=FacetTags({1: (0,), 2: (1,)})),
                         p=4, dtype=torch.float64, device=dev)
        sw = ShardedPaddedWave(m64, parts, kernel=kernel)
        pm = PaddedLinearWave(m64, tile_x=16, kernel=kernel)
        lay, solve, ref = sharded_solvers(sw, pm, kind)
        u, v = solve(0.0, 1e-9, 12)[:2]
        ur, vr = ref(0.0, 1e-9, 12)[:2]
        _, rel = state_err(torch.as_tensor(sw.to_global(u, lay)),
                           torch.as_tensor(sw.to_global(v, lay)),
                           pm.to_grid(ur).cpu(), pm.to_grid(vr).cpu())
        print(f"P20 f64 {kind} {parts} {kernel}: 12 steps against one device: relative "
              f"error {rel:.3e} (limit 1e-12)")
        check(rel <= 1e-12, f"P20 f64 {kind} {parts} against one device")
        if kind != "n":
            sw.refresh(v, lay)
        planes_bitwise(sw, v, lay, f"P20 f64 {kind} {parts}")
    # the 2-step RK4 (kernel J on the 6p value halo) from a random O(1)
    # state (a zero state leaves the deep halo exponentially small), against
    # one device's step path
    m64 = LinearWave(box_mesh((8, 4, 4), (0.01, 0.005, 0.005),
                              facet_tags=FacetTags({1: (0,), 2: (1,)})),
                     p=4, dtype=torch.float64, device=dev)
    sw = ShardedPaddedWave(m64, (2, 2, 1), tile_x=24)
    pm = PaddedLinearWave(m64, tile_x=24)
    lay = sw.halo_layout("step2")
    rng = np.random.default_rng(22)
    g0 = [rng.standard_normal(m64.ops.grid_shape) for _ in range(2)]
    u, v, _ = sw.solve_step2_n(0.0, 1e-9, 12, *(sw.from_global(g, lay) for g in g0))
    ur, vr, _ = pm.solve_step_n(0.0, 1e-9, 12, *(pm.from_grid(torch.as_tensor(g, device=dev))
                                                 for g in g0))
    _, rel = state_err(torch.as_tensor(sw.to_global_step2(u)),
                       torch.as_tensor(sw.to_global_step2(v)),
                       pm.to_grid(ur).cpu(), pm.to_grid(vr).cpu())
    print(f"P20 f64 step2 (2,2,1) flat, from a random state: 12 steps against one "
          f"device's solve_step_n: relative error {rel:.3e} (limit 1e-12)")
    check(rel <= 1e-12, "P20 f64 step2 against one device")
    sw.refresh(v, lay)
    planes_bitwise(sw, v, lay, "P20 f64 step2 (2,2,1)")
    del m64, sw, pm, u, v, ur, vr
    msw = [ShardedLinearWave(LinearWave(box_mesh((8, 4, 4), (0.01, 0.005, 0.005),
                                                 facet_tags=FacetTags({1: (0,), 2: (1,)})),
                                        p=4, dtype=torch.float64, device=dev), (2, 2, 1))]
    u, v, _ = msw[0].solve_n(0.0, 1e-9, 12)
    ur, vr = rk4_solve_n(msw[0].model.f0, msw[0].model.f1, *msw[0].model.zero_state(),
                         0.0, 1e-9, 12)
    _, rel = state_err(torch.as_tensor(msw[0].to_global(u)),
                       torch.as_tensor(msw[0].to_global(v)), ur.cpu(), vr.cpu())
    print(f"P20 f64 ShardedLinearWave (2,2,1), kernel F: relative error {rel:.3e} "
          "(limit 1e-12)")
    check(rel <= 1e-12, "P20 f64 ShardedLinearWave against LinearWave.solve")
    del msw

    phase(f"P20 halo-layout launches of A, H, I and J at the P1 width ({NDOFS:,} dofs, "
          "(2,2,1) blocks) against their plain versions, from NaN")
    case20, pm20 = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    m20 = case20.model
    sw20 = ShardedPaddedWave(m20, (2, 2, 1), tile_x=48)
    print("P20 blocks on devices: " + ", ".join(
        f"{sw20.mesh.coords(b)} -> {d}" for b, d in enumerate(sw20.mesh.devices)))
    grid20 = m20.ops.grid_shape
    rng20 = np.random.default_rng(20)
    g20 = [rng20.standard_normal(grid20), 1e3 * rng20.standard_normal(grid20)]
    halo_err = {}
    jb_grown = {}
    for kind, nfields, rings in (("step", 5, (0, 0)), ("lf", 3, (4, 0)),
                                 ("lf2", 5, (4, 0)), ("step2", 8, (0, 0))):
        lay = sw20.halo_layout(kind)
        u0 = sw20.refresh(sw20.from_global(g20[0], lay), lay)
        v0 = sw20.refresh(sw20.from_global(g20[1], lay), lay)
        worst = 0.0
        for b, (tables, st, src_x, abc_x) in enumerate(sw20._halo_tables(kind)):
            nan = [torch.full_like(u0[b], float("nan")) for _ in range(nfields)]
            c0 = m20.c0
            if kind == "step":
                gs = (1.0, 0.7, 0.4, 0.1)
                uk, vk = rk4step.rk4_step_lean(u0[b], v0[b], case20.dt, gs, lay, c0,
                                               tables, st, src_x, abc_x,
                                               out=tuple(nan[:2]), scratch=tuple(nan[2:]))
                up, vp = rk4step.rk4_step_lean_plain(u0[b], v0[b], case20.dt, gs, lay,
                                                     c0, tables)
            elif kind == "lf":
                uk, vk = lfstep.lf_step(u0[b], v0[b], case20.dt, 1.0, 0.6, lay, c0,
                                        tables, st, src_x, abc_x, out=tuple(nan[:2]),
                                        scratch=nan[2])
                up, vp = lfstep.lf_step_plain(u0[b], v0[b], case20.dt, 1.0, 0.6, lay,
                                              c0, tables)
            elif kind == "lf2":
                uk, vk = lf2step.lf2_step(u0[b], v0[b], case20.dt, 1.0, 0.6, 0.2, lay,
                                          c0, tables, st, src_x, abc_x,
                                          out=tuple(nan[:2]), scratch=tuple(nan[2:]))
                up, vp = lf2step.lf2_step_plain(u0[b], v0[b], case20.dt, 1.0, 0.6, 0.2,
                                                lay, c0, tables)
            else:
                # J's seven launches, each on its ring (ops.rk42step.call_rings);
                # the plain version computes the same boxes, so the whole
                # state compares
                jargs = (case20.dt, (1.0, 0.8, 0.55, 0.3, 0.1), lay, c0, st, *tables,
                         src_x, abc_x)
                uk, vk = rk42step.rk42_step_cuda(u0[b], v0[b], *jargs, out=tuple(nan[:2]),
                                                 scratch=tuple(nan[2:]))
                up, vp = rk42step.rk42_step_plain(u0[b], v0[b], *jargs)
                _, rel = state_err(uk, vk, up, vp)
                check(rel <= 1e-5, f"P20 step2 block {b}: the whole state against plain")
                if b == 0:
                    # the step boundary alone on its grown box (2p into the
                    # halo), on the stages this call left in the scratch
                    bring = rk42step.call_rings(lay)[0][3]
                    bins = (u0[b], v0[b], *nan[2:5])
                    bargs = rk42step.boundary_launch_args(
                        *bins, *nan[5:8], *tables, src_x, abc_x, case20.dt, 0.55, c0, lay,
                        st, bring)
                    x0, nx, h, ny, nz = lay.box(bring)
                    box_pts, pad_pts = nx * ny * nz, math.prod(lay.padded_shape)
                    q = 2 * lay.p
                    jb_bytes = uk.element_size() * (5 * (nx + q) * (ny + q) * (nz + q)
                                                    + 3 * pad_pts)
                    jb_grown = dict(
                        us=1e6 * timeit(_cuda.launcher(_cuda.library(),
                                                       "wave_rk42_boundary_tiled",
                                                       uk.dtype, dev, *bargs), reps=100),
                        bound_us=1e6 * jb_bytes / HBM_BYTES_PER_S, box=[nx, ny, nz],
                        box_points=box_pts, ring=bring, tiling=list(bargs[-7:]))
            torch.cuda.synchronize()
            inter = lay.interior
            _, rel = state_err(uk[inter], vk[inter], up[inter], vp[inter])
            worst = max(worst, rel)
            check(all(bool(torch.isfinite(x).all()) for x in nan),
                  f"P20 {kind} block {b}: no NaN left in its buffers")
            for x, r in zip((uk, vk), rings):
                x0, nx, h, ny, nz = lay.box(r)
                outside = x.clone()
                outside[x0 : x0 + nx, h : h + ny, h : h + nz] = 0.0
                check(float(outside.abs().max()) == 0.0,
                      f"P20 {kind} block {b}: zero outside its {r}-deep ring")
        halo_err[kind] = worst
        print(f"P20 {kind} on the {lay.h}-deep value-halo layout {lay.padded_shape}: "
              f"kernel against plain on the interior of every block: {worst:.3e} "
              f"(limit 1e-5)")
        check(worst <= 1e-5, f"P20 {kind}: halo-layout kernel against its plain version")
    print(f"J's step boundary on block 0's grown box {jb_grown['box']} (ring "
          f"{jb_grown['ring']}, tiling {jb_grown['tiling']}): {jb_grown['us']:.2f} "
          f"us/launch, bound {jb_grown['bound_us']:.2f} us (5 inputs over the box and "
          f"its p-deep ring, 3 padded outputs) [{smi}]")
    del u0, v0, uk, vk, up, vp, nan

    phase(f"P20 sharded solves at the P1 width ({NDOFS:,} dofs, f32, tile 48) and "
          "kernel E at P12's p = 10, against one device")
    case12b, epm12 = planar3d_app.build(**P12, dtype="f32", device="cuda")
    p20_runs = [  # (label, model, one-device model, parts, kind, kernel, steps)
        ("P20 step (2,1,1)", m20, pm20, (2, 1, 1), "step", "A", 100),
        ("P20 step (2,2,1)", m20, pm20, (2, 2, 1), "step", "A", 100),
        ("P20 lf (2,2,1)", m20, pm20, (2, 2, 1), "lf", "H", 100),
        ("P20 lf2 (2,2,1)", m20, pm20, (2, 2, 1), "lf2", "I", 100),
        ("P20 stage (2,1,1)", m20, pm20, (2, 1, 1), "n", "B", 100),
        ("P20 stage p=10 (2,1,1)", case12b.model, epm12, (2, 1, 1), "n", "E", 20),
        # P22: the 2-step RK4, kernel J on the 6p value halo
        ("P22 step2 (2,1,1)", m20, pm20, (2, 1, 1), "step2", "J", 100),
        ("P22 step2 (2,2,1)", m20, pm20, (2, 2, 1), "step2", "J", 100),
    ]
    class TimedExchange:
        """A solver's exchange with CUDA events around every slab swap (the
        halo-add's copies, the value-halo refresh), so the exchange's share
        is read inside the timed solve itself."""

        def __init__(self, inner):
            self.inner, self.mesh, self.spans = inner, inner.mesh, []

        @property
        def local_blocks(self):
            return self.inner.local_blocks

        def _timed(self, fn, *args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args)
            ev[1].record()
            self.spans.append(ev)
            return out

        def swap(self, *args):
            return self._timed(self.inner.swap, *args)

        def swap_into(self, *args):
            return self._timed(self.inner.swap_into, *args)

        def allreduce(self, x):
            return self.inner.allreduce(x)

        def gather(self, blocks):
            return self.inner.gather(blocks)

        def ms(self):
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.spans)

    def timed_exchange(sw):
        sw.exchange = TimedExchange(sw.exchange)
        return sw.exchange

    def hold_per_block(sw, kernel, label):
        """Kernel B, E or F on each block of a sharded model, at the
        block's shape and on the block's own tables, from a NaN output,
        against its plain version: f32 to 1e-5 relative, the padding zero."""
        worst = 0.0
        for b in range(sw.mesh.nblocks):
            if kernel == "F":
                ops = sw.local_ops
                tabs = stiffness.GridStiffnessTables(*tables_from_numpy(
                    stiffness.stiffness_grid_tables(
                        ops._sepA, ops._seplines, ops.grid_shape, ops.p,
                        -float(sw.model.c0) ** 2, ops.dtype), dev, ops.dtype))
                x = random_grid(ops.grid_shape, 300 + b, torch.float32)
                yk = stiffness.stiffness_grid_cuda(x, tabs, ops.p,
                                                   out=torch.full_like(x, float("nan")))
                yp = stiffness.stiffness_grid_plain(x, tabs, ops.p)
            else:
                lay = sw.layout
                x = random_padded(lay, 300 + b, torch.float32)
                nan = torch.full_like(x, float("nan"))
                if kernel == "B":
                    st = sw._tables[b][1]
                    yk = wave.apply_flat_cuda(x, lay, st, out=nan)
                    yp = wave.apply_stencil_plain(x, lay, st)
                else:
                    yk = wave.apply_slab_cuda(x, lay, sw._tables[b], out=nan)
                    yp = wave.apply_slab_plain(x, lay, sw._tables[b])
            torch.cuda.synchronize()
            _, rel = rel_err(yk, yp)
            worst = max(worst, rel)
            check(bool(torch.isfinite(yk).all()), f"{label} block {b}: no NaN left")
            if kernel != "F":
                padding_zero(lay, yk)
        shape = (sw.local_ops.grid_shape if kernel == "F" else sw.layout.padded_shape)
        print(f"{label}: kernel {kernel} on each of {sw.mesh.nblocks} blocks "
              f"{tuple(shape)} against its plain version, from NaN: max|err|/max|ref| "
              f"= {worst:.3e} (limit 1e-5)")
        check(worst <= 1e-5, f"{label}: kernel {kernel} against its plain version")
        return worst

    per_step_launches = {"step": 4, "lf": 2, "lf2": 1.5, "n": 4, "step2": 3.5}

    def device_ms_idle(fn, n):
        """(device ms/step, idle share) of ``fn()`` running ``n`` steps: the
        device time of every kernel and copy ``torch.profiler`` records,
        against the host clock of that profiled call."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host = 1e3 * (time.perf_counter() - t0) / n
        devms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
        return devms, 1.0 - devms / host
    p20 = {}
    for label, model, pm, parts, kind, kernel, n in p20_runs:
        tile = 48 if model.p == 4 else 16
        sw = ShardedPaddedWave(model, parts, tile_x=tile)
        lay, solve, ref = sharded_solvers(sw, pm, kind)
        dt = case20.dt if model is m20 else case12b.dt
        solve(0.0, dt, 2)  # tables, buffers, first launches
        if kind == "n":
            hold_per_block(sw, kernel, label)
        ex = timed_exchange(sw)
        tm = Timer(dev)
        zero_counts()
        with tm("solve"):
            u, v = solve(0.0, dt, n)[:2]
        counts = read_counts()
        ex_ms = ex.ms() / n
        sw.exchange = ex.inner
        nb = sw.mesh.nblocks
        want = int(per_step_launches[kind] * n) * nb
        check(counts[kernel] == want, f"{label}: kernel {kernel} launched "
              f"{counts[kernel]} times, want {want}")
        others = {k: c for k, c in counts.items() if k != kernel and c}
        check(not others, f"{label}: other kernels launched {others}")
        ms_step = 1e3 * tm.seconds("solve") / n
        ex_what = ("the halo-add's slab copies, events in the timed solve" if kind == "n"
                   else "the value-halo refresh of u and v, events in the timed solve")
        ur, vr = ref(0.0, dt, n)[:2]
        err, rel = state_err(torch.as_tensor(sw.to_global(u, lay)),
                             torch.as_tensor(sw.to_global(v, lay)),
                             pm.to_grid(ur).cpu(), pm.to_grid(vr).cpu())
        tm1 = Timer(dev)
        with tm1("one"):
            ref(0.0, dt, n)
        one_ms = 1e3 * tm1.seconds("one") / n
        if kind != "n":
            sw.refresh(v, lay)
        planes_bitwise(sw, v, lay, label)
        p20[label] = dict(kernel=kernel, parts=parts, steps=n, ms_per_step=ms_step,
                          one_device_ms_per_step=one_ms, exchange_ms_per_step=ex_ms,
                          exchange_share=ex_ms / ms_step, launches=counts[kernel],
                          launches_per_step=counts[kernel] / n, max_rel_err=rel,
                          layout=list(lay.padded_shape))
        if kind == "step2":
            dms, idle = device_ms_idle(lambda: solve(0.0, dt, 20), 20)
            p20[label].update(device_ms_per_step=dms, idle_share=idle)
            print(f"{label}: device {dms:.4f} ms/step (torch.profiler over 20 steps), "
                  f"idle {100 * idle:.1f} %")
        print(f"{label}: {ms_step:.4f} ms/step on {nb} blocks (one device "
              f"{one_ms:.4f}); exchange ({ex_what}) {ex_ms:.4f} ms/step, "
              f"{100 * ex_ms / ms_step:.1f} % of the step; kernel {kernel} "
              f"{counts[kernel] / n:g} launches/step; against one device "
              f"{rel:.3e} (limit 1e-4) [{smi}]")
        check(rel <= 1e-4, f"{label} against one device")
        del u, v, ur, vr, sw
    print("P20 " + json.dumps(p20))
    for parts in ("(2,1,1)", "(2,2,1)"):
        j, a = p20[f"P22 step2 {parts}"], p20[f"P20 step {parts}"]
        print(f"P22 step2 {parts}: {j['ms_per_step']:.4f} ms/step; one device's J "
              f"{j['one_device_ms_per_step']:.4f}; the sharded step A "
              f"{a['ms_per_step']:.4f}; exchange {100 * j['exchange_share']:.1f} % "
              f"against A's {100 * a['exchange_share']:.1f} % [{smi}]")

    phase("P20 ShardedLinearWave (kernel F per block) at the P1 width, (2,2,1)")
    msw = ShardedLinearWave(m20, (2, 2, 1))
    msw.solve_n(case20.t0, case20.dt, 1)
    hold_per_block(msw, "F", "P20 ShardedLinearWave (2,2,1)")
    ex = timed_exchange(msw)
    zero_counts()
    tm = Timer(dev)
    with tm("solve"):
        u, v, _ = msw.solve_n(case20.t0, case20.dt, 10)
    f_sharded = read_counts()["F"]
    f_ex_ms = ex.ms() / 10
    msw.exchange = ex.inner
    check(f_sharded == 4 * 10 * 4, f"P20 F launched {f_sharded} times, want 160")
    ur, vr = rk4_solve_n(m20.f0, m20.f1, *m20.zero_state(), case20.t0, case20.dt, 10)
    _, rel = state_err(torch.as_tensor(msw.to_global(u)), torch.as_tensor(msw.to_global(v)),
                       ur.cpu(), vr.cpu())
    f_ms = 1e3 * tm.seconds("solve") / 10
    print(f"P20 ShardedLinearWave: {f_ms:.4f} ms/step, F {f_sharded} launches; "
          f"exchange (the halo-add's slab copies, events in the timed solve) "
          f"{f_ex_ms:.4f} ms/step, {100 * f_ex_ms / f_ms:.1f} % of the step; against "
          f"LinearWave.solve {rel:.3e} (limit 1e-4) [{smi}]")
    check(rel <= 1e-4, "P20 ShardedLinearWave against one device")
    p20["P20 ShardedLinearWave (2,2,1)"] = dict(kernel="F", launches=f_sharded,
                                                ms_per_step=f_ms,
                                                exchange_ms_per_step=f_ex_ms,
                                                exchange_share=f_ex_ms / f_ms,
                                                max_rel_err=rel)
    del msw, u, v, ur, vr

    # the app's --ndev 4 at the P1 configuration, each counted alone
    p20_apps = {}
    for integrator, kernel, per_call, ref_label in (
            ("rk4", "A", 4, "P1 RK4, kernel A"), ("leapfrog", "H", 2,
                                                  "P2 leapfrog, kernel I")):
        phase(f"P20 app --ndev 4 --integrator {integrator} at {NDOFS:,} dofs")
        zero_counts()
        out = planar3d_app.run(**HEADLINE, integrator=integrator, ndev=4, dtype="f32",
                               device="cuda")
        counts = read_counts()
        print(json.dumps(out))
        want = per_call * (out["nsteps"] + 1) * 4
        name = ("sharded value-halo RK4 STEP kernel" if integrator == "rk4"
                else "sharded value-halo leapfrog STEP kernel")
        check(out["solver_path"] == name, f"P20 app {integrator}: solver_path")
        check(counts[kernel] == want, f"P20 app {integrator}: kernel {kernel} launched "
              f"{counts[kernel]} times, want {want}")
        others = {k: c for k, c in counts.items() if k != kernel and c}
        check(not others, f"P20 app {integrator}: other kernels launched {others}")
        rel = abs(out["u_norm"] - apps[ref_label]["u_norm"]) / apps[ref_label]["u_norm"]
        print(f"P20 app {integrator}: {out['nsteps']} steps, kernel {kernel} "
              f"{counts[kernel]} launches; |u| against {ref_label}: {rel:.3e} (limit "
              f"1e-4); {out['solve_seconds']:.4f} s [{smi}]")
        check(rel <= 1e-4, f"P20 app {integrator} against the one-device app")
        p20_apps[integrator] = (kernel, counts[kernel], out)

    # -- 19. Newmark on kernel F, the heterogeneous box ------------------
    phase(f"P23 Newmark (kernel F inside CG) at the P1 size ({NDOFS:,} dofs), f64, "
          "dt 10x the RK4 step")
    case23 = planar3d_case(ncells=HEADLINE["cells"], degree=4, dtype=torch.float64,
                           device=dev)
    m23 = case23.model
    dt23, n23 = 10 * case23.dt, 30
    stats = {}
    newmark_solve_n(m23, dt23, 2, *m23.zero_state(), stats=stats)  # tables, first launches
    zero_counts()
    tm = Timer(dev)
    with tm("newmark"):
        un, vn, an = newmark_solve_n(m23, dt23, n23, *m23.zero_state(), stats=stats)
    counts = read_counts()
    its = stats["cg_iterations"]
    p23_f = counts["F"]
    check(p23_f == sum(its) + 2 * n23 + 1, f"P23: kernel F launched {p23_f} times, "
          f"want {sum(its) + 2 * n23 + 1}")
    check(not {k: c for k, c in counts.items() if k != "F" and c},
          f"P23: other kernels launched {counts}")
    nm_ms = 1e3 * tm.seconds("newmark") / n23
    # RK4 at its own step over the same time (LinearWave.solve: kernel F in f1)
    ur, vr = rk4_solve_n(m23.f0, m23.f1, *m23.zero_state(), 0.0, case23.dt, 10 * n23)
    umax, urmax = float(un.abs().max()), float(ur.abs().max())
    check(bool(torch.isfinite(un).all() and torch.isfinite(vn).all()
               and torch.isfinite(an).all()), "P23: a finite Newmark state")
    check(0.0 < umax <= 2.0 * urmax, f"P23: max|u| {umax:.4e} bounded by twice RK4's "
          f"{urmax:.4e}")
    p23 = dict(steps=n23, dt=dt23, rk4_dt=case23.dt, cg_iterations=its,
               iterations_per_step=sum(its) / n23, ms_per_step=nm_ms, f_launches=p23_f,
               host_syncs_per_step=stats["host_syncs"] / n23, max_u=umax,
               rk4_max_u=urmax)
    print(f"P23 Newmark: {n23} steps of {dt23:.4e} s, CG {sum(its) / n23:.2f} "
          f"iterations/step ({min(its)}-{max(its)}), {nm_ms:.4f} ms/step, kernel F "
          f"{p23_f} launches, host syncs {stats['host_syncs'] / n23:.2f}/step; max|u| "
          f"{umax:.4e} against RK4's {urmax:.4e} at dt {case23.dt:.4e} [{smi}]")
    print("P23 " + json.dumps(p23))
    del case23, m23, un, vn, an, ur, vr

    phase(f"P24 a two-layer medium at the P1 size ({NDOFS:,} dofs, f32): 100 RK4 "
          "steps on the per-cell stiffness")
    # the small f64 check first: the per-cell path on the card against the CPU
    for d in ("cpu", dev):
        mesh24 = box_mesh((4, 2, 2), (1.0, 0.5, 0.5), facet_tags=FacetTags({1: (0,), 2: (1,)}))
        het = LinearWave(mesh24, p=3, c0=1.0, dtype=torch.float64, device=d,
                         c0_cells=np.where(np.arange(16) // 4 < 2, 1.0, 1.3))
        u, v, _ = het.solve(0.0, 25e-3, 1e-3, *het.zero_state())
        if d == "cpu":
            uc, vc = u, v
    _, rel = state_err(u.cpu(), v.cpu(), uc, vc)
    print(f"P24 f64 (4,2,2) two layers, 25 RK4 steps on the card against the CPU: "
          f"relative error {rel:.3e} (limit 1e-12)")
    check(rel <= 1e-12, "P24 f64 heterogeneous box against the CPU")
    case24 = planar3d_case(ncells=HEADLINE["cells"], degree=4, dtype=torch.float32,
                           device=dev)
    b24 = case24.model
    mids = (np.arange(b24.mesh.shape[0]) + 0.5) * b24.mesh.h[0]
    layer = np.repeat(mids < 0.5 * b24.mesh.h[0] * b24.mesh.shape[0],
                      b24.mesh.shape[1] * b24.mesh.shape[2])
    # the faster layer at the source, so the 100 steps' field (a few mm from
    # the source face) already feels the medium
    m24 = LinearWave(b24.mesh, p=4, c0=b24.c0, freq0=b24.freq0, p0=b24.p0,
                     dtype=torch.float32, device=dev,
                     c0_cells=np.where(layer, 1.3 * b24.c0, b24.c0))
    dt24 = case24.dt / 1.3  # the CFL step of the faster layer
    rk4_solve_n(m24.f0, m24.f1, *m24.zero_state(), 0.0, dt24, 2)
    zero_counts()
    tm = Timer(dev)
    with tm("het"):
        u, v = rk4_solve_n(m24.f0, m24.f1, *m24.zero_state(), 0.0, dt24, 100)
    counts = read_counts()
    check(not any(counts.values()), f"P24: the per-cell path launched {counts}")
    het_ms = 1e3 * tm.seconds("het") / 100
    uh, _ = rk4_solve_n(b24.f0, b24.f1, *b24.zero_state(), 0.0, dt24, 100)
    dif = float((u - uh).abs().max()) / float(uh.abs().max())
    check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()), "P24 finite")
    check(dif > 1e-3, f"P24: the two-layer field differs from the homogeneous {dif:.3e}")
    p24 = dict(steps=100, dt=dt24, ms_per_step=het_ms, max_u=float(u.abs().max()),
               rel_diff_homogeneous=dif)
    print(f"P24 two layers (1.3 c0, c0 across x = L/2): {het_ms:.4f} ms/step on the "
          f"per-cell path (plain torch: gather, element contraction, scatter); max|u| "
          f"{p24['max_u']:.4e}, {dif:.3e} of max|u| from the homogeneous model [{smi}]")
    print("P24 " + json.dumps(p24))
    del case24, b24, m24, u, v, uh

    # -- 9. the operator benchmark paths -----------------------------------
    def only(counts, kernel, label):
        others = {k: n for k, n in counts.items() if k != kernel and n}
        check(not others, f"{label}: other kernels launched {others}")

    phase(f"P6 cg_bench BP1 at {BP1_DOFS:,} dofs: kernel G")
    zero_counts()
    p6 = cg_bench.run(op="bp1", **BP1, dtype="f32", device="cuda", kmax=50, rtol=1e-4)
    counts = read_counts()
    print(json.dumps(p6))
    check(p6["ndofs"] == BP1_DOFS, "P6 ndofs")
    want = p6["solves"] * (1 + p6["iters"])
    print(f"P6: {p6['iters']} iterations, {p6['solves']} solves; kernel G "
          f"launches {counts['G']} = {p6['solves']} x (1 + {p6['iters']}); all "
          f"counts {counts}; {p6['ms_total']:.4f} ms/solve, "
          f"{p6['gdofs_iter_per_s']:.4f} GDoF*iterations/s [{smi}]")
    check(counts["G"] == want, f"P6: kernel G launched {counts['G']}, want {want}")
    only(counts, "G", "P6")
    launches["G"] = counts["G"]
    b = glay.pad(random_grid(glay.shape, 0, torch.float32))  # the bench's b
    xk, kk, _ = cg(lambda v: mass.mass_apply_cuda(v, glay, gtabs), b, kmax=50, rtol=1e-4)
    xp, kp, _ = cg(lambda v: mass.mass_apply_plain(v, glay, gtabs), b, kmax=50, rtol=1e-4)
    _, rel = rel_err(xk, xp)
    print(f"CG on kernel G: {kk} iterations; on the plain matvec: {kp}; "
          f"solutions max|dx|/max|x| = {rel:.3e} (limit 1e-3)")
    check(kk == p6["iters"] and abs(kk - kp) <= 1 and rel <= 1e-3,
          "CG on kernel G against CG on the plain matvec")
    del b, xk, xp

    p7 = {}
    for op, kernel in (("stiffness", "F"), ("bp1-mass", "G")):
        phase(f"P7 operators_bench {op} at {BP1_DOFS:,} dofs: kernel {kernel}")
        zero_counts()
        out = operators_bench.run(op=op, **BP1, check=True, dtype="f32", device="cuda")
        counts = read_counts()
        print(json.dumps(out))
        print(f"P7 {op}: kernel {kernel} launches {counts[kernel]} = "
              f"{out['applies']} applies; {out['ms_per_apply']:.4f} ms/apply; "
              f"error vs the f64 oracle {out['max_rel_err_vs_f64_oracle']:.3e} "
              f"(limit 1e-5) [{smi}]")
        check(out["ndofs"] == BP1_DOFS, f"P7 {op} ndofs")
        check(counts[kernel] == out["applies"], f"P7 {op}: kernel {kernel} "
              f"launched {counts[kernel]}, want {out['applies']}")
        only(counts, kernel, f"P7 {op}")
        check(out["max_rel_err_vs_f64_oracle"] <= 1e-5, f"P7 {op} against f64")
        p7[op] = counts[kernel]
    launches["F"] = p7["stiffness"]

    # -- 10. kernel K -------------------------------------------------------
    C0SQ = 1500.0**2

    def k_bound(t, itemsize):
        """(bound_ms, bound_by) of one kernel K apply: x and y once, the
        dofmap and the geometry (per node, or per cell and w) over the HBM
        rate, against the element contractions' and the scatter's flops
        over the f32 peak. The design's own traffic (the pass that sets y
        to 0, the colours' reads of y, the colour lists) is not counted."""
        m, nq, nc, nd = t.m, t.nq, t.ncells, t.m**3
        nb = 2 * t.ndofs * itemsize + nbytes(t.dofmap, t.geo) + (nbytes(t.w) if t.affine else 0)
        fwd = 2 * m * (nq * m * m + nq * nq * m + nq**3)  # m^3 -> nq^3 points
        bwd = 2 * nq * (m * nq * nq + m * m * nq + m**3)  # and back
        per_cell = {"mass": 2 * nd, "stiffness": nd * (12 * m + 16),
                    "mass_gauss": fwd + nq**3 + bwd + nd,
                    "stiffness_gauss": 3 * fwd + 15 * nq**3 + 3 * bwd + nd}[t.mode]
        return op_bound(nb, nc * (per_cell + nd))

    def random_dofs(n, seed, dtype):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                               dtype=dtype, device=dev)

    def k_check(ops, mode, seed, coeff):
        """(tables, x, max|err|, relative error, two applies bitwise equal)
        of kernel K against its plain version on ``ops``' tables."""
        t = ops.tables(mode, dev)
        x = random_dofs(ops.ndofs, seed, ops.dtype)
        yk = general.general_apply_cuda(x, t, coeff)
        yk2 = general.general_apply_cuda(x, t, coeff)
        yp = general.general_apply_plain(x, t, coeff)
        torch.cuda.synchronize()
        err, rel = rel_err(yk, yp)
        return t, x, err, rel, bool(torch.equal(yk, yk2))

    def perturbed(cells, seed):
        """The JAX tests' perturbed mesh (interior vertices jittered by 0.02)."""
        ext = np.array([1.0, 0.8, 0.9])
        hm = box_mesh(cells, tuple(ext)).to_hex_mesh()
        pts = hm.points.copy()
        inner = np.all((pts > 1e-9) & (pts < ext - 1e-9), axis=1)
        pts[inner] += 0.02 * np.random.default_rng(seed).standard_normal(pts[inner].shape)
        return HexMesh(points=pts, cells=hm.cells)

    phase("kernel K (general_apply) against general_apply_plain")
    for rule, ps in (("gll", (1, 2, 4, 6)), ("gauss", (1, 2, 4))):
        for p in ps:
            cells = (2, 2, 2) if p >= 6 else (4, 3, 3) if p >= 3 else (5, 4, 3)
            hm = perturbed(cells, p)
            ops = GeneralOperators(hm, build_dofmap(hm, p), dtype=torch.float64, rule=rule)
            for op, coeff in (("mass", 1.0), ("stiffness", -C0SQ)):
                mode = op if rule == "gll" else f"{op}_gauss"
                _, _, _, rel, bitwise = k_check(ops, mode, 40 + p, coeff)
                print(f"f64 {mode} p={p} {cells}: max|err|/max|ref| = {rel:.3e} "
                      f"(limit 1e-12); two applies bitwise equal: {bitwise}")
                check(rel <= 1e-12 and bitwise, f"kernel K f64 {mode} p={p}")
    for p in (2, 4):  # affine cells: the rank-1 geometry
        hm = box_mesh((4, 3, 2), (1.0, 0.8, 0.9)).to_hex_mesh()
        ops = GeneralOperators(hm, build_dofmap(hm, p), dtype=torch.float64)
        check(ops.affine, "a box has affine cells")
        for op, coeff in (("mass", 1.0), ("stiffness", -C0SQ)):
            t, x, _, rel, bitwise = k_check(ops, op, 60 + p, coeff)
            oracle = (ops.stiffness_indexed(x, 1500.0) if op == "stiffness"
                      else ops.spectral_mass_roundtrip(x))
            _, rel_o = rel_err(general.general_apply_cuda(x, t, coeff), oracle)
            print(f"f64 affine {op} p={p}: against plain {rel:.3e}, against the "
                  f"per-node indexed oracle {rel_o:.3e} (limit 1e-12)")
            check(t.affine and rel <= 1e-12 and rel_o <= 1e-12 and bitwise,
                  f"kernel K affine {op} p={p}")

    # -- 16. the general-model set-up on the card ---------------------------
    phase(f"general set-up on the card (csrc/setup_kernels.cu) at the P8 size against "
          "the NumPy route")
    zero_counts()
    gmodel, gsetup = general_solve.build(HEADLINE["cells"], degree=4, dtype="f32")
    setup_paths = {"P8 build": read_setup()}
    print(f"P8 model: perturbed {gmodel.mesh.ncells} cells, p=4, {gmodel.ndofs} dofs, "
          f"affine {gmodel.ops.affine}; set-up on the card {gsetup:.3f} s (mesh, "
          f"dofmap, geometry, lumped mass, boundary weights); set-up launches "
          f"{setup_paths['P8 build']} [{smi}]")
    check(setup_paths["P8 build"] == {"geometry": 1, "keys": 1, "dedup": 3},
          f"P8 build's set-up launches {setup_paths['P8 build']}")
    setup = setup_phase(gmodel, gsetup, smi, dev)
    for k, (err, ms, plain_ms, bnd, lib_ms) in setup["kernels"].items():
        results[k] = (err, ms, plain_ms, bnd)
        library[k] = lib_ms
    t0 = time.perf_counter()
    k_colours = np.diff(gmodel.ops.colouring[1]).tolist()
    print(f"P8 colouring: {len(k_colours)} colours of {k_colours} cells "
          f"({time.perf_counter() - t0:.2f} s)")
    check(len(k_colours) == 8, "the perturbed box takes the parity 8-colouring")
    check(gmodel.ndofs == NDOFS and not gmodel.ops.affine, "the P8 model")
    k_modes, k_wrapper_ms = {}, {}
    for mode, coeff in (("stiffness", -C0SQ), ("mass", 1.0)):
        t0 = time.perf_counter()
        t, x, err, rel, bitwise = k_check(gmodel.ops, mode, 70, coeff)
        print(f"f32 P8 {mode}: max|err| = {err:.6e}, max|err|/max|ref| = {rel:.3e} "
              f"(limit 1e-5); two applies bitwise equal: {bitwise} (tables and "
              f"check {time.perf_counter() - t0:.1f} s)")
        check(rel <= 1e-5 and bitwise, f"kernel K f32 {mode} at the P8 size")
        out_k = torch.empty_like(x)
        wrapper_ms = 1e3 * timeit(lambda: general.general_apply_cuda(x, t, coeff,
                                                                     out=out_k))
        ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_general_apply", x.dtype,
                                         dev, *general.launch_args(x, out_k, t, coeff)),
                          reps=200)
        plain_ms = 1e3 * timeit(lambda: general.general_apply_plain(x, t, coeff),
                                reps=3, warmup=1)
        k_modes[mode] = (err, ms, plain_ms, k_bound(t, 4))
        k_wrapper_ms[mode] = wrapper_ms
        print(f"kernel K {mode}: {ms:.4f} ms/apply (through the wrapper "
              f"{wrapper_ms:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{k_modes[mode][3][0]:.4f} ms ({k_modes[mode][3][1]}) [{smi}]")
        del x, out_k
    results["K"] = k_modes["stiffness"]

    # -- 11. the general-mesh paths ----------------------------------------
    k_paths = {}
    for label, integrator in (("P8", "rk4"), ("P9", "leapfrog")):
        phase(f"{label} general_solve {integrator} at {NDOFS:,} dofs: kernel K")
        zero_counts()
        out = general_solve.run(s=16, degree=4, steps=200, integrator=integrator,
                                model=gmodel)
        counts = read_counts()
        print(json.dumps(out))
        want = out["solves"] * out["applies_per_solve"]
        print(f"{label}: {out['steps']} steps x {out['solves']} solves; kernel K "
              f"launches {counts['K']} = {out['solves']} x {out['applies_per_solve']}; "
              f"{out['ms_per_step']:.4f} ms/step, {out['gdof_steps_per_s']:.4f} "
              f"GDoF*steps/s, vmax {out['vmax']:.4e} [{smi}]")
        check(out["ndofs"] == NDOFS and math.isfinite(out["vmax"]), f"{label} record")
        check(counts["K"] == want, f"{label}: kernel K launched {counts['K']}, want {want}")
        only(counts, "K", label)
        k_paths[label] = counts["K"]

    # -- 15. the imported-mesh workflow ----------------------------------
    # P16/P17: the app's general branch on the P8 model written as XDMF
    # (binary), P18: the box branch's --output at the P1 configuration,
    # P19: probe recording and the energy; each path counted alone
    def only_k(counts, want, label):
        check(counts["K"] == want, f"{label}: kernel K launched {counts['K']}, want {want}")
        only(counts, "K", label)

    p15_k, p15_f = {}, {}
    with tempfile.TemporaryDirectory(prefix="_p16_", dir=ROOT) as tmp:
        phase(f"P16 imported-mesh app, RK4, at {NDOFS:,} dofs: kernel K")
        t0 = time.perf_counter()
        mesh_path, tags_path = os.path.join(tmp, "mesh.xdmf"), os.path.join(tmp, "tags.xdmf")
        ft = gmodel.facet_tags
        write_xdmf_mesh(mesh_path, gmodel.mesh)
        write_xdmf_meshtags(tags_path, gmodel.mesh, np.concatenate([ft[1], ft[2]]),
                            [1] * len(ft[1]) + [2] * len(ft[2]))
        print(f"wrote the P8 mesh ({gmodel.mesh.ncells} cells) and its {len(ft[1])} + "
              f"{len(ft[2])} tagged facets as binary XDMF in "
              f"{time.perf_counter() - t0:.2f} s")
        out_path = os.path.join(tmp, "out.xdmf")
        cfg16 = SimulationConfig()
        cfg16.domain.mesh_path, cfg16.domain.meshtags_path = mesh_path, tags_path
        cfg16.run.output_path = out_path
        # the card route on P16's mesh as read back, against phase 16's NumPy
        # route on the same points and cells, and bitwise against the P8 model
        t0 = time.perf_counter()
        gx = general_wave.from_xdmf(mesh_path, tags_path, p=4, dtype=torch.float32,
                                    device="cuda")
        torch.cuda.synchronize()
        gx_s = time.perf_counter() - t0
        check(np.array_equal(gx.mesh.points, gmodel.mesh.points)
              and np.array_equal(gx.mesh.cells, gmodel.mesh.cells)
              and all(np.array_equal(gx.facet_tags[t], ft[t]) for t in (1, 2)),
              "P16's mesh and tags read back as written")
        rx = {"ndofs": gx.ndofs == setup["ndofs"],
              "dofmap": np.array_equal(gx.dofs.dofmap, setup["dofmap"]),
              "affine": gx.ops.affine == gmodel.ops.affine,
              **{k: torch.equal(getattr(gx, k), getattr(gmodel, k)) for k in ("m", "W1", "W2")},
              "G": torch.equal(gx.ops._G, gmodel.ops._G)}
        w_rel = max(float((getattr(gx, f"W{t}").double().cpu()
                           - torch.as_tensor(setup["W"][t].astype(np.float32)).double())
                          .abs().max() / float(np.abs(setup["W"][t]).max())) for t in (1, 2))
        m_rel = float((gx.m.cpu() - torch.as_tensor(setup["m"])).abs().max()
                      / float(np.abs(setup["m"]).max()))
        print(f"P16's mesh on the card: from_xdmf {gx_s:.3f} s; against the NumPy route "
              f"and bitwise the P8 model: {rx}; m {m_rel:.3e}, W {w_rel:.3e} (limit 1e-6)")
        check(all(rx.values()) and m_rel <= 1e-6 and w_rel <= 1e-6,
              "the card set-up on P16's mesh")
        del gx
        zero_counts()
        p16, u16, v16 = planar3d_app.run(cfg16, dtype="f32", device="cuda",
                                         return_state=True)
        counts = read_counts()
        setup_paths["P16"] = read_setup()
        check(setup_paths["P16"] == {"geometry": 1, "keys": 1, "dedup": 3},
              f"P16's set-up launches {setup_paths['P16']}")
        print(json.dumps(p16))
        n16 = p16["nsteps"]
        print(f"P16: {n16} steps (steps/period {p16['steps_per_period']}, dt "
              f"{p16['dt']:.6e}); kernel K applies {counts['K']} = 4 x ({n16} + 1 "
              f"warm-up step), each 1 + {len(k_colours)} launches; mesh read "
              f"{p16['read_seconds']:.3f} s, setup {p16['setup_seconds']:.2f} s, solve "
              f"{p16['solve_seconds']:.4f} s, output {p16['output_seconds']:.2f} s, "
              f"{p16['gdof_steps_per_s']:.4f} GDoF*steps/s [{smi}]")
        check(p16["ndofs"] == NDOFS and "CUDA kernel K" in p16["solver_path"], "P16 record")
        only_k(counts, 4 * (n16 + 1), "P16")
        p15_k["P16"] = counts["K"]
        vmax = float(v16.abs().max())
        check(math.isfinite(vmax) and 0 < vmax < 1e15, f"P16 |v| {vmax:.3e}")
        t0 = time.perf_counter()
        back = read_xdmf(out_path)
        fields = read_xdmf_attributes(out_path)
        print(f"P16 output read back in {time.perf_counter() - t0:.2f} s: "
              f"{back.ncells} sub-hexes, {len(back.points)} points, |v| max {vmax:.4e}")
        check(np.array_equal(back.points, gmodel.dofs.dof_coords),
              "P16 output points equal the dof coordinates")
        check(back.ncells == gmodel.mesh.ncells * 4**3, "P16 output sub-hexes")
        for name, x in (("u", u16), ("v", v16)):
            check(np.array_equal(fields[name], x.cpu().double().numpy()),
                  f"P16 output {name} equals the returned state")
        del back, fields

        phase("P17 imported-mesh app, leapfrog, 400 steps in chunks of 100: kernel K")
        cfg17 = SimulationConfig.from_json(cfg16.to_json())
        cfg17.run.output_path = None
        cfg17.run.checkpoint_every_steps = 100
        cfg17.time.integrator = "leapfrog"
        zero_counts()
        p17, u17, v17 = planar3d_app.run(cfg17, dtype="f32", device="cuda", steps=400,
                                         checkpoint_dir=os.path.join(tmp, "ckpt"),
                                         return_state=True)
        counts = read_counts()
        setup_paths["P17"] = read_setup()
        check(setup_paths["P17"] == {"geometry": 1, "keys": 1, "dedup": 3},
              f"P17's set-up launches {setup_paths['P17']}")
        print(json.dumps(p17))
        print(f"P17: 400 steps, kernel K applies {counts['K']} = 400 + 4 chunk starts + "
              f"2 (warm-up step); setup {p17['setup_seconds']:.2f} s, solve "
              f"{p17['solve_seconds']:.4f} s [{smi}]")
        check(p17["nsteps"] == 400 and "general leapfrog" in p17["solver_path"], "P17 record")
        only_k(counts, 400 + 4 + 2, "P17")
        p15_k["P17"] = counts["K"]
        ur, vr = gmodel.solve_n(0.0, p17["dt"], 400, integrator="leapfrog")
        _, rel = state_err(u17, v17, ur, vr)
        print(f"P17 against one unchunked 400-step solve of the P8 model: relative "
              f"error {rel:.3e} (limit 1e-5)")
        check(rel <= 1e-5, "P17 chunked against unchunked")
        del u16, v16, u17, v17, ur, vr

        phase("P18 the box branch's --output at the P1 configuration: kernel A")
        out18 = os.path.join(tmp, "box.xdmf")
        zero_counts()
        p18, u18, v18 = planar3d_app.run(**HEADLINE, dtype="f32", device="cuda", steps=100,
                                         output=out18, return_state=True)
        counts = read_counts()
        print(json.dumps(p18))
        check(counts["A"] == 4 * (100 + 1)
              and not {k: n for k, n in counts.items() if k != "A" and n},
              f"P18: launches {counts}")
        fields = read_xdmf_attributes(out18)
        for name, x in (("u", u18), ("v", v18)):
            check(np.array_equal(fields[name], hpm.to_grid(x).cpu().double().numpy()),
                  f"P18 output {name} equals to_grid of the returned state")
        dg = StructuredDofGrid(hpm.base.mesh, hpm.base.p)
        z, y, x = read_xdmf_geometry(out18)
        check(all(np.array_equal(a, dg.axis_coords(d)) for d, a in enumerate((x, y, z))),
              "P18 node lines equal StructuredDofGrid's")
        print(f"P18: kernel A {counts['A']} launches; output {p18['output_seconds']:.3f} s "
              f"[{smi}]")
        del u18, v18, fields

        # -- 18. the distributed imported mesh: P21 --------------------------
        # P16's mesh on 4 RCB parts, every part on this card: the numbers are
        # the one-card cost of the assembly and of the per-part launches, not
        # scaling
        from wave_fenics_tpu_torch.benchmarks import scatter_bench
        from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave

        phase(f"P21 sharded general set-up: P16's mesh ({NDOFS:,} dofs) on 4 RCB parts")
        t0 = time.perf_counter()
        sw21 = ShardedGeneralWave(gmodel, 4, exchange="allgather")
        s21 = sw21._setup
        t1 = time.perf_counter()
        ns21 = sw21._nbr_setup
        t2 = time.perf_counter()
        tb21 = sw21.prepare()._tables
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        setup21 = {"partition_and_tables_s": t1 - t0, "pairwise_tables_s": t2 - t1,
                   "device_tables_s": t3 - t2}
        auto21 = "ppermute" if ns21["NR"] * ns21["Sb"] < 4 * s21["S"] else "allgather"
        parts21 = [dict(part=i, cells=t.ncells, dofs=t.ndofs, colours=t.ncolours,
                        interface_slots=len(s21["bidx"][i]))
                   for i, t in tb21["K"].items()]
        print(f"P21 set-up (host NumPy, then the parts' tables on the card): "
              f"{json.dumps(setup21)}; S = {s21['S']} slots, K = {s21['K']} other copies "
              f"at most, {ns21['NR']} rounds of buckets up to {ns21['Sb']} slots, "
              f"auto -> {auto21}; dofs held by 3+ parts: "
              f"{int((s21['counts'] >= 3).sum())}")
        print("P21 parts: " + json.dumps(parts21))
        check(sum(p["cells"] for p in parts21) == gmodel.mesh.ncells, "P21 parts' cells")

        phase("P21 kernel K on each part against its plain version, from NaN")
        for info, (i, t) in zip(parts21, tb21["K"].items()):
            x = random_dofs(t.ndofs, 210 + i, torch.float32)
            yk = general.general_apply_cuda(x, t, -C0SQ, out=torch.full_like(x, float("nan")))
            yk2 = general.general_apply_cuda(x, t, -C0SQ)
            yp = general.general_apply_plain(x, t, -C0SQ)
            torch.cuda.synchronize()
            err, rel = rel_err(yk, yp)
            bitwise = bool(torch.equal(yk, yk2))
            out_k = torch.empty_like(x)
            ms = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_general_apply", x.dtype,
                                             dev, *general.launch_args(x, out_k, t, -C0SQ)),
                              reps=200)
            bms, by = k_bound(t, 4)
            info.update(max_abs_err=err, rel_err=rel, ms=ms, bound_ms=bms, bound_by=by)
            print(f"P21 part {i}: {t.ncells} cells, {t.ndofs} dofs, {t.ncolours} colours; "
                  f"K against plain {rel:.3e} (limit 1e-5), two applies bitwise equal: "
                  f"{bitwise}; {ms:.4f} ms/apply, bound {bms:.4f} ms ({by}) [{smi}]")
            check(rel <= 1e-5 and bitwise and bool(torch.isfinite(yk).all()),
                  f"P21 part {i}: kernel K against its plain version")
            del x, yk, yk2, yp, out_k

        def timed_assembly(sw):
            """CUDA events around every assembly (packing, the collective and
            the adds) of ``sw``'s solves until ``del sw._assemble``."""
            spans, inner = [], sw._assemble

            def assemble(b):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = inner(b)
                ev[1].record()
                spans.append(ev)
                return out

            sw._assemble = assemble
            return spans

        phase(f"P21 sharded solves at {NDOFS:,} dofs (f32, 4 parts, 100 steps) against one "
              "device; f64 on the 6x4x4 perturbed box on 8 parts")
        dt21, dt21lf = p16["dt"], p17["dt"]
        one21 = {}
        for integrator, dtx in (("rk4", dt21), ("leapfrog", dt21lf)):
            tm1 = Timer(dev)
            with tm1("one"):
                one21[integrator] = gmodel.solve_n(0.0, dtx, 100, integrator=integrator)
            one21[integrator + "_ms"] = 1e3 * tm1.seconds("one") / 100
        p21, v21g, p21_k = {}, {}, {}
        for label, mode, integrator, dtx in (("rk4 allgather", "allgather", "rk4", dt21),
                                             ("rk4 ppermute", "ppermute", "rk4", dt21),
                                             ("leapfrog auto", "auto", "leapfrog", dt21lf)):
            t0 = time.perf_counter()
            sw = ShardedGeneralWave(gmodel, 4, exchange=mode).prepare()
            torch.cuda.synchronize()
            set_s = time.perf_counter() - t0
            sw.solve_n(0.0, dtx, 1, integrator=integrator)  # first launches
            spans = timed_assembly(sw)
            tm = Timer(dev)
            zero_counts()
            with tm("solve"):
                u, v, _ = sw.solve_n(0.0, dtx, 100, integrator=integrator)
            counts = read_counts()
            asm_ms = sum(a.elapsed_time(b) for a, b in spans) / 100
            del sw._assemble
            only_k(counts, 4 * (4 * 100 if integrator == "rk4" else 100 + 1), f"P21 {label}")
            p21_k[f"P21 {label}"] = counts["K"]
            ms_step = 1e3 * tm.seconds("solve") / 100
            ur, vr = one21[integrator]
            _, rel = state_err(torch.as_tensor(sw.to_global(u)),
                               torch.as_tensor(sw.to_global(v)), ur.cpu(), vr.cpu())
            v21g[label] = sw.to_global(v)
            rec = dict(exchange=sw.exchange_mode, steps=100, ms_per_step=ms_step,
                       one_device_ms_per_step=one21[integrator + "_ms"],
                       assembly_ms_per_step=asm_ms, assembly_share=asm_ms / ms_step,
                       launches=counts["K"], max_rel_err=rel, setup_s=set_s)
            if label == "rk4 allgather":
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    sw.solve_n(0.0, dtx, 20)
                    torch.cuda.synchronize()
                    prof_ms = 1e3 * (time.perf_counter() - t0) / 20
                dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 20
                rec.update(device_ms_per_step=dev_ms, idle_share=1.0 - dev_ms / prof_ms)
                print(f"P21 {label}: profiled 20 steps: device {dev_ms:.4f} ms/step of "
                      f"{prof_ms:.4f} ms/step (idle {100 * rec['idle_share']:.1f} %) [{smi}]")
            p21[label] = rec
            print(f"P21 {label} ({sw.exchange_mode}): {ms_step:.4f} ms/step on 4 parts (one "
                  f"device {one21[integrator + '_ms']:.4f}); assembly (events around every "
                  f"_assemble in the timed solve) {asm_ms:.4f} ms/step, "
                  f"{100 * asm_ms / ms_step:.1f} % of the step; kernel K {counts['K']} "
                  f"launches; against one device {rel:.3e} (limit 1e-4); tables "
                  f"{set_s:.2f} s [{smi}]")
            check(rel <= 1e-4, f"P21 {label} against one device")
            del sw, u, v
        va, vp = v21g["rk4 allgather"], v21g["rk4 ppermute"]
        modes_rel = float(np.abs(vp - va).max() / np.abs(va).max())
        print(f"P21 allgather against ppermute: {modes_rel:.3e} (limit 1e-6)")
        check(modes_rel <= 1e-6, "P21 the two assembly modes agree")
        del one21, v21g, va, vp
        hm64, tags64 = general_solve.perturbed_box((6, 4, 4))
        g64 = GeneralLinearWave(hm64, 4, tags64, dtype=torch.float64, device=dev)
        for mode, integrator in (("allgather", "rk4"), ("ppermute", "rk4"),
                                 ("auto", "leapfrog")):
            sw = ShardedGeneralWave(g64, 8, exchange=mode)
            u, v, _ = sw.solve_n(0.0, 1e-9, 12, integrator=integrator)
            ur, vr = g64.solve_n(0.0, 1e-9, 12, integrator=integrator)
            _, rel = state_err(torch.as_tensor(sw.to_global(u)),
                               torch.as_tensor(sw.to_global(v)), ur.cpu(), vr.cpu())
            print(f"P21 f64 (6,4,4) p=4, 8 parts, {integrator} {sw.exchange_mode}: 12 steps "
                  f"against one device {rel:.3e} (limit 1e-12); dofs held by 3+ parts: "
                  f"{int((sw._setup['counts'] >= 3).sum())}")
            check(rel <= 1e-12, f"P21 f64 {integrator} {mode} against one device")
        del g64, sw, u, v, ur, vr

        phase(f"P21 app --mesh --ndev 4 at {NDOFS:,} dofs: RK4 to tf, then leapfrog 400 "
              "steps in chunks of 100 with a resume")
        cfg21 = SimulationConfig.from_json(cfg16.to_json())
        cfg21.run.output_path = None
        cfg21.run.ndev = 4
        zero_counts()
        p21a, u21, _ = planar3d_app.run(cfg21, dtype="f32", device="cuda", return_state=True)
        counts = read_counts()
        print(json.dumps(p21a))
        n21 = p21a["nsteps"]
        only_k(counts, 4 * 4 * (n21 + 1), "P21 app rk4")
        p21_k["P21 app rk4"] = counts["K"]
        rel = abs(p21a["u_norm"] - p16["u_norm"]) / p16["u_norm"]
        print(f"P21 app rk4: {n21} steps, {p21a['exchange']}, kernel K {counts['K']} = 4 "
              f"parts x 4 x ({n21} + 1 warm-up step); |u| against P16's {rel:.3e} (limit "
              f"1e-4); setup {p21a['setup_seconds']:.2f} s, solve "
              f"{p21a['solve_seconds']:.4f} s ({1e3 * p21a['solve_seconds'] / n21:.4f} "
              f"ms/step; P16 one device {1e3 * p16['solve_seconds'] / n16:.4f}) [{smi}]")
        check(p21a["solver_path"] == "sharded general (rk4, RCB, ndev=4)"
              and p21a["ndev"] == 4 and p21a["exchange"] == auto21, "P21 app record")
        check(rel <= 1e-4, "P21 app rk4 against the one-device app")
        del u21
        cfg21l = SimulationConfig.from_json(cfg21.to_json())
        cfg21l.time.integrator = "leapfrog"
        cfg21l.run.checkpoint_every_steps = 100
        ck21 = os.path.join(tmp, "ck21")
        # the references: one unchunked solve on the app's path (4 parts,
        # auto), and one on one device
        sw21a = ShardedGeneralWave(gmodel, 4)
        ua, va, _ = sw21a.solve_n(0.0, p17["dt"], 400, integrator="leapfrog")
        ua, va = torch.as_tensor(sw21a.to_global(ua)), torch.as_tensor(sw21a.to_global(va))
        ur, vr = (x.cpu() for x in gmodel.solve_n(0.0, p17["dt"], 400,
                                                  integrator="leapfrog"))
        _, rel1 = state_err(ua, va, ur, vr)
        print(f"P21 leapfrog, 400 steps, unchunked: 4 parts ({sw21a.exchange_mode}) against "
              f"one device {rel1:.3e} (limit 1e-4)")
        check(rel1 <= 1e-4, "P21 leapfrog, 400 steps, against one device")
        for label, want in (("P21 app leapfrog", 400 + 4 + 2),
                            ("P21 app leapfrog resumed", 200 + 2 + 2)):
            if label.endswith("resumed"):
                snaps = sorted(os.listdir(ck21))
                check(len(snaps) == 3, f"P21 snapshots {snaps}")
                os.remove(os.path.join(ck21, snaps[-1]))
            zero_counts()
            out, u, v = planar3d_app.run(cfg21l, dtype="f32", device="cuda", steps=400,
                                         checkpoint_dir=ck21, return_state=True)
            counts = read_counts()
            only_k(counts, 4 * want, label)
            p21_k[label] = counts["K"]
            _, rel = state_err(torch.as_tensor(sw21a.to_global(u)),
                               torch.as_tensor(sw21a.to_global(v)), ua, va)
            print(f"{label}: from step {out['resumed_from_step']}, kernel K {counts['K']} = "
                  f"4 x {want}; against the unchunked 4-part solve {rel:.3e} (limit 1e-5) "
                  f"[{smi}]")
            check(out["nsteps"] == 400 and "sharded general (leapfrog" in out["solver_path"],
                  f"{label} record")
            check(rel <= 1e-5, f"{label} against the unchunked solve")
        check(out["resumed_from_step"] == 200, "P21 the resumed run starts at step 200")
        del u, v, ua, va, ur, vr, tb21, sw21a

        phase("P21 cg_bench --op general --s 16 --p 4 --ndev 4")
        zero_counts()
        cg21 = cg_bench.run(op="general", s=16, degree=4, ndev=4, dtype="f32", device="cuda")
        counts = read_counts()
        print(json.dumps(cg21))
        want = cg21["solves"] * (1 + cg21["iters"]) * 4 + 1 + cg21["iters_single_device"]
        only_k(counts, want, "P21 cg_bench")
        p21_k["P21 cg_bench"] = counts["K"]
        print(f"P21 cg_bench: {cg21['iters']} iterations ({cg21['iters_single_device']} on "
              f"one device), {cg21['exchange']}, solution {cg21['max_rel_solution_diff']:.3e} "
              f"from one device's (limit 1e-2); {cg21['ms_total']:.4f} ms/solve; K "
              f"{counts['K']} launches [{smi}]")
        check(abs(cg21["iters"] - cg21["iters_single_device"]) <= 1, "P21 cg_bench parity")

        phase("P21 scatter_bench: local and halo at --size 64 --degree 4, general-halo at "
              "--size 32 --degree 4")
        scatter21 = {}
        for kw in (dict(mode="local", size=64, check=True), dict(mode="halo", size=64),
                   dict(mode="general-halo", size=32, exchange="allgather"),
                   dict(mode="general-halo", size=32, exchange="ppermute")):
            zero_counts()
            r = scatter_bench.run(degree=4, dtype="f32", device="cuda", **kw)
            counts = read_counts()
            print(json.dumps(r))
            check(not any(counts.values()), f"scatter_bench {kw}: no kernel, {counts}")
            scatter21[r["metric"]] = r.get("us_per_exchange", r.get("ms"))
        p21["scatter_bench"] = scatter21
        p21["parts"] = parts21
        p21["setup"] = setup21
        print("P21 " + json.dumps(p21))

    phase(f"P19 recording on kernel K ({NDOFS:,} dofs) and kernel F; the energy")
    dt16 = p16["dt"]
    probes = gmodel.dofs.dof_coords[[1000, NDOFS // 2, NDOFS - 1000]]
    zero_counts()
    ur, vr, series = general_wave.solve_recording(gmodel, 0.0, dt16, 200, probes)
    counts = read_counts()
    only_k(counts, 800, "P19 general recording")
    p15_k["P19"] = counts["K"]
    us, vs = gmodel.solve_n(0.0, dt16, 200)
    ids = torch.as_tensor(general_wave.probe_dofs(gmodel, probes), device=dev)
    check(torch.equal(ur, us) and torch.equal(vr, vs),
          "recording's final state bitwise equal to solve_n's")
    check(series.shape == (200, 3) and torch.equal(series[-1], ur[ids]),
          "the last series row equals u at the probes")
    print(f"P19 general: 200 RK4 steps, 3 probes, kernel K {counts['K']} applies; "
          f"final state bitwise equal to solve_n's; |series| max "
          f"{float(series.abs().max()):.4e}")
    del ur, vr, us, vs, series
    box = box_mesh((16, 8, 8), (0.01, 0.005, 0.005), facet_tags=FacetTags({1: (0,), 2: (1,)}))
    lwg, lwc = (LinearWave(box, p=4, dtype=torch.float64, device=d) for d in (dev, "cpu"))
    pts = np.array([[0.002, 0.001, 0.002], [0.005, 0.0025, 0.0025], [0.009, 0.004, 0.001]])
    zero_counts()
    ug, vg, sg = linear_wave.solve_recording(lwg, 0.0, 1e-9, 25, pts)
    counts = read_counts()
    check(counts["F"] == 100 and not {k: n for k, n in counts.items() if k != "F" and n},
          f"P19 box recording launches {counts}")
    p15_f["P19"] = counts["F"]
    uc, vc, sc = linear_wave.solve_recording(lwc, 0.0, 1e-9, 25, pts)
    _, rel_s = rel_err(sg.cpu(), sc)
    _, rel = state_err(ug.cpu(), vg.cpu(), uc, vc)
    print(f"P19 box (16,8,8) p=4 f64: 25 steps on kernel F ({counts['F']} launches); "
          f"series {rel_s:.3e}, state {rel:.3e} against the CPU (limit 1e-12)")
    check(rel_s <= 1e-12 and rel <= 1e-12, "P19 box recording against the CPU")
    hm_e, tags_e = general_solve.perturbed_box((8, 4, 4))
    gg, gc = (GeneralLinearWave(hm_e, 4, tags_e, dtype=torch.float64, device=d)
              for d in (dev, "cpu"))
    rng = np.random.default_rng(15)
    for label, mg, mc, kernel in (("box", lwg, lwc, "F"), ("general", gg, gc, "K")):
        shape = tuple(mc.zero_state()[0].shape)
        u, v = rng.standard_normal(shape), rng.standard_normal(shape)
        e_c = float(diagnostics.energy(mc, torch.as_tensor(u), torch.as_tensor(v)))
        zero_counts()
        e_g = float(diagnostics.energy(mg, torch.as_tensor(u, device=dev),
                                       torch.as_tensor(v, device=dev)))
        counts = read_counts()
        rel = abs(e_g - e_c) / abs(e_c)
        print(f"P19 energy, {label} f64: card {e_g:.15e}, CPU {e_c:.15e}, relative "
              f"{rel:.3e} (limit 1e-12); launches {counts}")
        check(rel <= 1e-12, f"P19 energy ({label}) against the CPU")
        check(counts[kernel] == (1 if kernel == "F" else 2)
              and not {k: n for k, n in counts.items() if k != kernel and n},
              f"P19 energy ({label}) launches {counts}")
        (p15_f if kernel == "F" else p15_k)[f"P19 energy {label}"] = counts[kernel]
    del gmodel, lwg, gg

    for op in ("stiffness-general", "mass-general", "stiffness-gauss", "mass"):
        phase(f"P10 operators_bench {op} at {NDOFS:,} dofs: kernel K")
        zero_counts()
        t0 = time.perf_counter()
        out = operators_bench.run(op=op, s=16, degree=4, check=True, dtype="f32",
                                  device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(json.dumps(out))
        print(f"P10 {op}: kernel K launches {counts['K']} = {out['applies']} applies; "
              f"{out['ms_per_apply']:.4f} ms/apply; error vs the f64 oracle "
              f"{out['max_rel_err_vs_f64_oracle']:.3e} (limit 1e-5); host setup "
              f"{out['setup_s']:.2f} s, {wall:.1f} s in all with the f64 oracle [{smi}]")
        check(out["ndofs"] == NDOFS, f"P10 {op} ndofs")
        check(counts["K"] == out["applies"], f"P10 {op}: kernel K launched "
              f"{counts['K']}, want {out['applies']}")
        only(counts, "K", f"P10 {op}")
        check(out["max_rel_err_vs_f64_oracle"] <= 1e-5, f"P10 {op} against f64")
        k_paths[f"P10 {op}"] = counts["K"]
        # the op and its f64 oracle set up on the card on one dofmap
        setup_paths[f"P10 {op}"] = read_setup()
        check(setup_paths[f"P10 {op}"] == {"geometry": 2, "keys": 1, "dedup": 1},
              f"P10 {op}'s set-up launches {setup_paths[f'P10 {op}']}")
        k_modes[f"P10 {op}"] = out["ms_per_apply"]

    phase(f"P11 cg_bench general at {NDOFS:,} dofs: kernel K (mass_gauss)")
    zero_counts()
    t0 = time.perf_counter()
    p11 = cg_bench.run(op="general", s=16, degree=4, precond=True, dtype="f32",
                       device="cuda", kmax=50, rtol=1e-4)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(json.dumps(p11))
    want = p11["solves"] * (1 + p11["iters"])
    print(f"P11: {p11['iters']} iterations, {p11['solves']} solves; kernel K launches "
          f"{counts['K']} = {p11['solves']} x (1 + {p11['iters']}); "
          f"{p11['ms_total']:.4f} ms/solve, {p11['gdofs_iter_per_s']:.4f} "
          f"GDoF*iterations/s; host setup {p11['setup_s']:.2f} s, {wall:.1f} s in all "
          f"[{smi}]")
    check(p11["ndofs"] == NDOFS, "P11 ndofs")
    check(counts["K"] == want, f"P11: kernel K launched {counts['K']}, want {want}")
    only(counts, "K", "P11")
    k_paths["P11"] = counts["K"]
    setup_paths["P11"] = read_setup()
    check(setup_paths["P11"] == {"geometry": 1, "keys": 1, "dedup": 1},
          f"P11's set-up launches {setup_paths['P11']}")

    phase("the assembled CSR SpMV and the element-assembly operator against kernel K "
          "at 16^3 cells, p=4")
    t0 = time.perf_counter()
    hm16, _ = general_solve.perturbed_box((16, 16, 16))
    ops16 = GeneralOperators(hm16, build_dofmap(hm16, 4), dtype=torch.float32)
    t1 = time.perf_counter()
    A_e16 = assemble_element_tensors(hm16, 4, kind="stiffness", coeff=-C0SQ, clamp=True)
    A = assemble_csr(ops16.dofs, A_e16)
    A16 = csr_tensor(A, dev, torch.float32)
    ea16 = EAOperator(ops16.dofs, A_e16, dtype=torch.float32, device=dev)
    del A_e16
    print(f"{ops16.ndofs} dofs: host setup {t1 - t0:.2f} s; CSR with {A.nnz} "
          f"entries, host assembly {time.perf_counter() - t1:.1f} s")
    del A
    t16, x, err16, rel, bitwise = k_check(ops16, "stiffness", 80, -C0SQ)
    check(rel <= 1e-5 and bitwise, "kernel K f32 stiffness at 16^3 cells")
    y_csr = torch.sparse.mm(A16, x[:, None])[:, 0]
    _, rel_csr = rel_err(general.general_apply_cuda(x, t16, -C0SQ), y_csr)
    out_k = torch.empty_like(x)
    ms16 = 1e3 * timeit(_cuda.launcher(_cuda.library(), "wave_general_apply", x.dtype, dev,
                                       *general.launch_args(x, out_k, t16, -C0SQ)),
                        reps=200)
    csr_ms = 1e3 * timeit(lambda: torch.sparse.mm(A16, x[:, None]))
    plain16 = 1e3 * timeit(lambda: general.general_apply_plain(x, t16, -C0SQ),
                           reps=3, warmup=1)
    bound16 = k_bound(t16, 4)
    print(f"kernel K {ms16:.4f} ms/apply, CSR SpMV {csr_ms:.4f} ms, plain "
          f"{plain16:.4f} ms, bound {bound16[0]:.4f} ms ({bound16[1]}); K against "
          f"the CSR SpMV: max|err|/max|ref| = {rel_csr:.3e} (limit 1e-5) [{smi}]")
    check(rel_csr <= 1e-5, "kernel K against the assembled CSR SpMV")
    _, rel_ea = rel_err(ea16(x), general.general_apply_cuda(x, t16, -C0SQ))
    ea_ms = 1e3 * timeit(lambda: ea16(x), reps=50)
    ea_bytes = ea16.A_e.numel() * 4 + ea16.dofmap.numel() * 8 + 2 * x.numel() * 4
    ea = dict(ms=ea_ms, k_ms=ms16, csr_ms=csr_ms, rel_err_vs_k=rel_ea,
              a_e_bytes=ea16.A_e.numel() * 4,
              bytes_bound_ms=1e3 * ea_bytes / HBM_BYTES_PER_S)
    print(f"EAOperator (gather, torch.bmm of the stored A_e [{ea16.A_e.shape[0]}, "
          f"{ea16.A_e.shape[1]}, {ea16.A_e.shape[2]}], index_add_ scatter; TF32 off): "
          f"{ea_ms:.4f} ms/apply beside kernel K {ms16:.4f} ms and the CSR SpMV "
          f"{csr_ms:.4f} ms; its bytes (A_e, the dofmap, x, y) over the HBM rate "
          f"{ea['bytes_bound_ms']:.4f} ms; against K: max|err|/max|ref| = {rel_ea:.3e} "
          f"(limit 1e-5) [{smi}]")
    print("EA " + json.dumps(ea))
    check(rel_ea <= 1e-5, "EAOperator against kernel K")
    del x, out_k, y_csr, ea16

    # phases 21-23: tsmm, the dry run and the four examples, each counted alone
    slice21 = slice_phases(dev, smi, counters, setup_counters)
    p24 = bf16_phase(dev, smi, counters, setup_counters)
    p25 = bf16_paths_phase(dev, smi, counters, setup_counters, f32_states)
    del f32_states
    f32_apps = {"P16 --mesh": p16, "P21 --mesh --ndev 4": p21a,
                **{f"P20 --ndev 4 {i}": r[2] for i, r in p20_apps.items()}}
    p26 = bf16_rest_phase(dev, smi, counters, setup_counters, f32_apps,
                          (A16, hm16, ops16.dofs))
    del A16
    p27 = suite_phase(dev, smi, counters, setup_counters)
    # B, E and F beside the one PyTorch call that computes their function at
    # their widths here: torch.sparse.mm of the assembled operator as a CSR
    # matrix with int32 indices (apps/kernel_times.py; checked within 1e-5)
    phase("kernels B (P1), E (P12) and F (257^3) beside torch.sparse.mm of the assembled "
          "int32 CSR")
    from wave_fenics_tpu_torch.apps import kernel_times

    csr = kernel_times.library_times(torch, 100)
    for k, r in csr.items():
        library[k] = r["library_ms"]
        print(f"kernel {k} {r['cells']} p={r['p']}: {r['kernel_ms']:.4f} ms by events "
              f"({r['kernel_device_ms']:.4f} on the device); torch.sparse.mm of the CSR "
              f"({r['nnz']:,} nnz, {r['index_dtype']}) {r['library_ms']:.4f} ms "
              f"({r['library_device_ms']:.4f} on the device), its bound "
              f"{r['library_bound_ms']:.4f}; against the kernel {r['rel_err']:.3e} "
              f"(limit 1e-5) [{smi}]")

    # "kernels": all eleven, each with the launches of its path's run (G:
    # P6, F: P7 stiffness, K: P8, E: P12, J: P14; B: the f1-path check,
    # since no app path at p <= 8 launches it)
    src_flat = "wave_fenics_tpu_torch/csrc/flat_tiled.cu"
    src_rk42 = "wave_fenics_tpu_torch/csrc/rk42_tiled.cu"
    src_mass = "wave_fenics_tpu_torch/csrc/mass_tiled.cu"
    src_lf = "wave_fenics_tpu_torch/csrc/lf_tiled.cu"
    src_rk4 = "wave_fenics_tpu_torch/csrc/rk4_tiled.cu"
    src_slab = "wave_fenics_tpu_torch/csrc/slab_tiled.cu"
    src_stage = "wave_fenics_tpu_torch/csrc/rk_stage_tiled.cu"
    src_grid = "wave_fenics_tpu_torch/csrc/stiffness_tiled.cu"
    src_gen = "wave_fenics_tpu_torch/csrc/general_kernels.cu"
    src_setup = "wave_fenics_tpu_torch/csrc/setup_kernels.cu"
    results["A"] = (a_err, sum(a_stage_us) / 1e3, a_plain_ms, a_bound)
    results["B"] = (b_err, b_ms, b_plain_ms, b_bound)
    # K and F: their paths' runs, and the imported-mesh workflow's (phase 15)
    launches["K"] = k_paths["P8"] + sum(p15_k.values())
    launches["F"] += sum(p15_f.values()) + p23_f
    launches["B"] = f1_launches
    # the sharded runs (phase 17), each counted alone, added to their kernels
    sharded_launches = {}
    for label, r in p20.items():
        sharded_launches.setdefault(r["kernel"], {})[label] = r["launches"]
    for integrator, (kernel, n, _) in p20_apps.items():
        sharded_launches.setdefault(kernel, {})[f"P20 app --ndev 4 {integrator}"] = n
    sharded_launches.setdefault("K", {}).update(p21_k)
    for kernel, per_path in sharded_launches.items():
        launches[kernel] += sum(per_path.values())
    dryrun_launches = slice21["dryrun"]["launches"]
    example_launches = {}
    for name, e in slice21["examples"].items():
        for kernel, n in e["launches"].items():
            example_launches.setdefault(kernel, {})[name] = n
    for kernel, n in dryrun_launches.items():
        launches[kernel] += n
    for kernel, per_example in example_launches.items():
        launches[kernel] += sum(per_example.values())
    # phase 27: the quick suite's run, counted alone
    for kernel, n in p27["launches"].items():
        launches[kernel] += n
    meta = {
        "A": ("rk4_tiled_kernel<T, P, J>, lean (kernel A: lean RK4 step, 4 stage "
              "launches on the 2.5D tiled stencil; ms per step)",
              "wave_fenics_tpu/ops/pallas_rk4step.py:201", src_rk4),
        "B": ("apply_flat_tiled_kernel<T, P> (kernel B: stiffness/m on the flat "
              "layout, 2.5D tiled stencil with TMA plane loads, p=4, the P1 layout; ms "
              "per apply; launches: the f1-path RK4, 2 steps, and P20's per-stage "
              "sharded run)",
              "wave_fenics_tpu/ops/pallas_wave.py:336", src_flat),
        "C": ("rk4_tiled_kernel<T, P, J>, full tableau (kernel C: full-tableau "
              "RK4 step, 4 stage launches on the 2.5D tiled stencil; ms per step)",
              "wave_fenics_tpu/ops/pallas_rk4step.py:67", src_rk4),
        "D": ("rk_stage_tiled_kernel<T, P> (kernel D: one fused RK4 stage on the "
              "2.5D tiled stencil with TMA plane loads, p=8; ms per stage launch)",
              "wave_fenics_tpu/ops/pallas_wave.py:573", src_stage),
        "H": ("lf_phase_tiled_kernel<T, P, Phase> OPEN+CLOSE (kernel H: one leapfrog "
              "step on the 2.5D tiled stencil with TMA plane loads, p=8; ms per step, "
              "the phase launches back to back)",
              "wave_fenics_tpu/ops/pallas_lfstep.py:62", src_lf),
        "I": ("lf_phase_tiled_kernel<T, P, Phase> OPEN+MID+CLOSE (kernel I: two "
              "leapfrog steps on the 2.5D tiled stencil with TMA plane loads, p=4; ms "
              "per call, the phase launches back to back)",
              "wave_fenics_tpu/ops/pallas_lf2step.py:70", src_lf),
        "F": ("stiffness_tiled_kernel<T, P> (kernel F: separable stiffness on the "
              "unpadded grid, 2.5D tiled stencil with cp.async plane loads, 64^3 "
              "cells, p=4; ms per apply)",
              "wave_fenics_tpu/ops/pallas_stiffness.py:146", src_grid),
        "G": ("mass_tiled_kernel<T, P> (kernel G: BP1 consistent Gauss mass on the "
              "padded layout, 2.5D tiled with TMA plane loads, contracting z, y, x, "
              "64^3 cells, p=4; ms per apply)",
              "wave_fenics_tpu/ops/pallas_mass.py:45", src_mass),
        "K": ("general_zero_kernel + general_stiffness_kernel<T, M, Affine> per "
              "colour (kernel K: explicit-dofmap matvec, stiffness with per-node G "
              "on the perturbed 64x32x32-cell box, p=4, 8 colour launches; ms per "
              "apply)",
              "wave_fenics_tpu/ops/pallas_general.py:185", src_gen),
        "E": ("apply_slab_tiled_kernel<T, P> (kernel E: stiffness/m on the 3D-slab "
              "layout, 2.5D tiled stencil with TMA plane loads, p=10, 26x13x13 "
              "cells; ms per apply)",
              "wave_fenics_tpu/ops/pallas_wave.py:128", src_slab),
        "J": ("rk42_boundary_tiled_kernel<T, P> + 6 stages of kernel C's "
              "rk4_tiled_kernel<T, P, J> (csrc/rk4_tiled.cu) (kernel J: two "
              "full-tableau RK4 steps, 7 launches, p=4; ms per call of 2 steps)",
              "wave_fenics_tpu/ops/pallas_rk42step.py:97", src_rk42),
        "Jb": ("rk42_boundary_tiled_kernel<T, P> alone (kernel J's step boundary: "
               "step 1's stage 3, its full-tableau (u1, v1) and step 2's stage 0, "
               "2.5D tiled with TMA plane loads of 5 fields, p=4, the P1 width; ms "
               "per launch; launches: one per call on P14)",
               "wave_fenics_tpu/ops/pallas_rk42step.py:97", src_rk42),
        # the set-up kernels (phase 16): counterparts of the JAX package's
        # host library, not of a TPU kernel; launches: P16's model build
        "geometry": ("geometry_factors_kernel (general set-up: G and |det J| w of "
                     "the P8 model, 65,536 cells x 125 points, f64, clamped; ms per "
                     "launch)", "wave_fenics_tpu/native/wavecore.cpp:32", src_setup),
        "keys": ("node_keys_kernel (general set-up: the quantized keys and "
                 "coordinates of the P8 model's 8,192,000 nodes; ms per launch)",
                 "wave_fenics_tpu/core/dofmap.py:168", src_setup),
        "dedup": ("dedup_insert_kernel + dedup_lookup_kernel (general set-up: hash "
                  "dedup of the P8 model's 8,192,000 node keys into 4,276,737 dofs, "
                  "numbered by first appearance; ms per call with the table's fill; "
                  "library: torch.unique(dim=0, return_inverse=True), sorted "
                  "numbering)", "wave_fenics_tpu/native/wavecore.cpp:87", src_setup),
    }
    for k in ("geometry", "keys", "dedup"):
        launches[k] = setup_paths["P16"][k]
    kernels = []
    for k, (name, replaces, source) in meta.items():
        err, ms, plain_ms, (bms, by) = results[k]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library.get(k),
        })
    by_name = {k: entry for k, entry in zip(meta, kernels)}
    by_name["K"]["launches_per_path"] = {**k_paths, **p15_k}
    by_name["F"]["launches_per_path"] = {"P7 stiffness": p7["stiffness"], **p15_f,
                                         "P23 Newmark": p23_f}
    by_name["K"]["ms_per_mode"] = {"P8 mass": k_modes["mass"][1], **{
        k: v for k, v in k_modes.items() if k.startswith("P10")}}
    by_name["B"]["app_path_launches"] = b_on_paths
    by_name["E"]["launches_per_path"] = {
        label: path_counts[label]["E"] for label in path_counts if "kernel E" in label}
    # "ms" of A and C: the four stage launches; wrapper_ms_per_step: one
    # call of the wrapper per step, its operand checks included
    by_name["A"]["stage_us"] = a_stage_us
    by_name["A"]["wrapper_ms_per_step"] = a_ms
    by_name["C"]["stage_us"] = c_stage_us
    by_name["C"]["wrapper_ms_per_step"] = c_ms
    by_name["J"]["two_c_steps_ms"] = c2_ms
    by_name["J"]["boundary_ms"] = jb_ms
    # the boundary on block 0's grown box of the 6p layout (P1 width, (2,2,1))
    by_name["J"]["sharded_boundary_us"] = jb_grown
    by_name["G"]["wrapper_ms"] = g_wrapper_ms
    # "ms" of B and F: back-to-back launches; wrapper_ms: through the wrapper
    by_name["B"]["wrapper_ms"] = b_wrapper_ms
    by_name["F"]["wrapper_ms"] = f_wrapper_ms
    # "ms" of D and E: back-to-back launches; wrapper_ms: through the
    # wrapper, its operand checks included
    by_name["D"]["wrapper_ms"] = d_wrapper_ms
    by_name["E"]["wrapper_ms"] = e_wrapper_ms
    # "ms" of H and I: their phase launches back to back; of K: back-to-back
    # applies (launcher with its arguments converted once)
    by_name["H"]["phase_us"] = h_phase_us
    by_name["H"]["wrapper_ms"] = h_wrapper_ms
    by_name["I"]["phase_us"] = i_phase_us
    by_name["I"]["wrapper_ms"] = i_wrapper_ms
    by_name["K"]["wrapper_ms"] = k_wrapper_ms["stiffness"]
    by_name["K"]["P21_parts"] = parts21
    by_name["K"]["colours"] = k_colours
    for k in ("geometry", "keys", "dedup"):
        by_name[k]["launches_per_path"] = {label: c[k] for label, c in setup_paths.items()}
    by_name["dedup"]["wrapper_ms"] = setup["dedup_wrapper_ms"]
    by_name["geometry"]["detJw_err_vs_80bit"] = {
        "card": setup["detJw_80bit"][0], "numpy": setup["detJw_80bit"][1]}
    by_name["geometry"]["setup_s"] = {"card": setup["card_setup"],
                                      "card_second": setup["card_setup2"],
                                      "numpy": setup["np_setup"]}
    by_name["J"]["odd_step_launches_A"] = path_counts["P14 RK4 two-step, kernel J"]["A"]
    for kernel, per_path in sharded_launches.items():
        by_name[kernel]["sharded_launches"] = per_path
    for kernel, n in dryrun_launches.items():
        by_name[kernel]["dryrun_launches"] = n
    for kernel, per_example in example_launches.items():
        by_name[kernel]["example_launches"] = per_example
    for kernel, n in p27["launches"].items():
        by_name[kernel]["suite_launches"] = n
    for k, r in csr.items():
        by_name[k]["library"] = {key: r[key] for key in (
            "nnz", "index_dtype", "rel_err", "library_device_ms", "library_bound_ms",
            "kernel_ms", "kernel_device_ms")}
    # the same kernel at 16^3 cells, beside the one PyTorch call that computes
    # its function there (the assembled matrix at the P8 size would not fit
    # a host assembly)
    kernels.append({
        "name": "general_zero_kernel + general_stiffness_kernel<T, M, Affine> per "
                "colour (kernel K: stiffness with per-node G on the perturbed "
                f"16^3-cell box, p=4, {ops16.ndofs} dofs; ms per apply; library: "
                "torch.sparse.mm of the assembled CSR matrix)",
        "route": "cuda", "source": src_gen,
        "replaces": "wave_fenics_tpu/ops/pallas_general.py:185",
        "launches": launches["K"], "max_abs_err": err16, "ms": ms16,
        "plain_ms": plain16, "bound_ms": bound16[0], "bound_by": bound16[1],
        "library_ms": csr_ms,
    })
    # phase 24: each bf16 kernel's launches (its checks and, for A, the
    # app's main path), its time beside the f32 kernel's in this call
    for k in ("A", "B", "C", "D", "F"):
        by_name[k]["bf16_launches"] = p24["launches"].get(k, 0) + p24["app"][
            "launches"].get(k, 0)
        if k in p24["times"]:
            by_name[k]["bf16"] = p24["times"][k]
    by_name["A"]["bf16_app"] = p24["app"]
    # phase 25: E, H, I and J likewise (J: its step boundary's times; A adds
    # the odd last step of P14's bf16 run)
    for k in ("A", "E", "H", "I", "J"):
        by_name[k]["bf16_launches"] = (by_name[k].get("bf16_launches", 0)
                                       + p25["launches"].get(k, 0))
        if k in p25["times"]:
            by_name[k]["bf16"] = p25["times"][k]
    for label, run in p25["app"].items():
        kernel = label.split("kernel ")[-1]
        by_name[kernel].setdefault("bf16_app", {})[label] = run
    # phase 26: G and K likewise (K: its four modes at P8 and, with the bf16
    # CSR, at 16^3 cells); the bf16 app runs of K, A (P20 RK4) and H (P20
    # leapfrog), and the benchmarks' bf16 records
    for k in ("G", "K"):
        by_name[k]["bf16_launches"] = p26["launches"].get(k, 0)
    by_name["G"]["bf16"] = p26["times"]["G"]
    by_name["K"]["bf16"] = {k[2:]: t for k, t in p26["times"].items() if k.startswith("K ")}
    for label, run in p26["app"].items():
        kernel = next(iter(run["launches"]))
        by_name[kernel].setdefault("bf16_app", {})[label] = run
        by_name[kernel]["bf16_launches"] = (by_name[kernel].get("bf16_launches", 0)
                                            + (0 if kernel == "K" else run["launches"][kernel]))
    by_name["G"]["bf16_bench"] = {k: b for k, b in p26["bench"].items() if "G" in b["launches"]}
    by_name["K"]["bf16_bench"] = {k: b for k, b in p26["bench"].items() if "K" in b["launches"]}
    print("tsmm " + json.dumps(slice21["tsmm"]))
    print("bf16 " + json.dumps({**p24["checks"], **p25["checks"], **p26["checks"]}))
    print("dryrun " + json.dumps(slice21["dryrun"]))
    print(f"total {time.perf_counter() - t_start:.1f} s after the device check")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
