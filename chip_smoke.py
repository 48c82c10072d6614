#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fdapde_core_tpu_torch) on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. require a CUDA device; print torch/CUDA versions and the card's name
   and power limit (nvidia-smi);
2. build the package's CUDA kernels from csrc/ (nvcc) and print the time;
3. hold the fused coords->stencil kernel against its plain PyTorch version
   on the card (n = 3200 in f32 at the main path's shapes; n = 257 in f32
   and f64 on junk-padded planes), tolerance 8 eps(dtype) max|L|, and time
   both with CUDA events;
4. drive the main path: StructuredPoisson(3200, float32) operator ->
   multigrid -> mixed-precision MG-CG solve, with every kernel's launch
   count reset just before and K1's read just after;
5. harmonic check at n = 256 in f64: Dirichlet data g = x + y is
   reproduced to 1e-10;
6. 500 Jacobi-CG iterations on the n = 3200 operator with f32 and bf16
   stencil storage;
7. hold the ELL gather SpMV kernel (K2) against its plain PyTorch version
   on the card, on the n = 3200 P1 operator of the block-scrambled
   irregular mesh (10.25M rows, built by the port's own pipeline): float32,
   float64 and bfloat16 values, and a rectangular case (n_src != n, n not
   a multiple of the block), and float32 values against a float64 x
   (widened in the kernel: equal bitwise to the float64 launch on the
   converted table); per-row tolerance K eps(acc) sum_k |vals x|; bitwise
   stable; the square tables with their warp widths (warp_w: each 32 rows
   read the slots their widest row uses), equal bitwise to the launch
   without; timed with and without the widths with CUDA events in float32
   and float64 beside torch.sparse CSR of the stored entries, against the
   bound on the stored entries (and, labelled, on the slots read);
8. drive the general-mesh main path: MatrixFreeElliptic(K=1,
   gather_kernel="lane") on the scrambled n = 3200 mesh with the default
   preconditioner="auto" (the band plan must reject the numbering, so the
   model is "auxgrid+lane"), load_vector(1), solve(rtol=1e-8); every
   kernel's launch count reset just before and K2's read just after; the
   true residual recomputed through the plain SpMV in f64 must be <= 1e-8
   within 150 inner iterations; the solve run again must take as many
   iterations and give the same solution bitwise (every sum of the path,
   the aux grid's P^T on K2's sliced form included, runs in a fixed order);
   P^T timed beside the index_add_ it replaced, a torch.sparse CSR SpMV
   and its bound;
9. MatrixFreePoisson on the unscrambled n = 3200 mesh (aux grid, f64 ELL
   on K2) converges to 1e-9;
10. harmonic check on the scrambled n = 256 mesh through the lane path:
    Dirichlet data g = x + y is reproduced to 1e-9;
11. hold the closed-form P1 local-stiffness kernels K4, K5 and K6 against
    their plain PyTorch versions on the card, tolerance 8 eps(dtype)
    max|A|, bitwise stable: K6 on the (6, C) coordinates of phase 12's
    mesh in f64 and f32, and all three in f32 on the perturbed n = 3200
    criss-cross mesh (20.48M cells) as cell coordinates and edge vectors;
    time each and its plain version with CUDA events; then, with the
    launch counts zeroed, the structured-stencil path p1_grid_stencil(K4)
    and p1_grid_stencil_offdiag(K5) against K1's stencil_from_coords on
    the same planes (32 eps max|L|: the three sum in other orders);
12. drive the general-mesh PDE API path at bench.py's `general` size:
    PDE(Triangulation(jittered Delaunay, nx = 720: 519,841 dofs, ~1.04M
    cells), -laplacian(), order=1, device="cuda") with forcing
    2 pi^2 sin(pi x) sin(pi y), g = 0 and rtol 1e-12 ("auto" -> auxgrid),
    every launch count zeroed before init() and K6's read after solve();
    the solve must converge without the recovery step, with the true
    residual recomputed on the host in f64 <= 1e-10 (CG stops on its
    recurrence residual; the true one drifts from it by about iterations x
    eps || |A| |x| || / ||b||, printed beside it), and an L2 error below
    1e-5;
13. harmonic reproduction through the same PDE on the same mesh (g = x + y,
    f = 0, to 1e-9), and the entry() problem on unit_square_mesh(32)
    (f = 4, g = 1 - x^2 - y^2) converges;
14. hold the off-diagonal-planes kernel K3 against its plain version (n =
    3200 in f32 at its path's shapes; n = 257 in f32 and f64 on junk-padded
    planes), tolerance 8 eps(dtype) max|plane|, bitwise stable, both timed
    with CUDA events; then, with the launch counts zeroed, its path
    stencil_from_offdiag_planes(K3) against K1's stencil_from_coords on the
    same planes (32 eps max|L|);
16. drive the DIA-storage API path at unit_square_mesh(1024) (1,050,625
    dofs) in f64 with every launch count zeroed: assemble_dia ->
    prune_zero_offsets -> solve_elliptic (Jacobi CG, forcing
    2 pi^2 sin(pi x) sin(pi y), g = 0, rtol 1e-8) converges, its true
    residual recomputed in f64 printed beside its rounding floor, and K7
    launched at least once per iteration; GridDIAMatrix.from_dia -> GridMG
    MG-CG converges in <= 15 iterations and agrees with the Jacobi solution
    to 1e-6 max|x|; harmonic g = x + y through solve_elliptic on the DIA
    operator (V-cycle preconditioner) is reproduced to 1e-9;
15. (run after 16, on its operator) hold the DIA SpMV kernel K7 against its
    plain version on the DIA path's (5, 1,050,625) f64 operator and on the
    n = 3200 K1 stencil flattened to a (7, 10,246,401) f32 DIA matrix (whose
    entries that would wrap across a grid row are checked to be exactly 0,
    so it equals the grid stencil's product); per-row tolerance K eps
    sum_k |data x|, bitwise stable; time K7, the plain version and a
    torch.sparse CSR SpMV (cuSPARSE, built once from to_sparse()) on each;
17. point location on phase 12's mesh: 2,000,000 points drawn uniformly
    from [-0.02, 1.02]^2 on the card (some outside the domain), located by
    DeviceCellLocator on the card and by the host CellLocator: the ids must
    be equal on every point; both timed, the bin table's K and bytes
    printed;
18. drive the regression path on the same mesh with every launch count
    zeroed: SmoothingRegression(mesh, -laplacian()) (K6 assembles P),
    select_lambda_gcv over LAMBDAS (Hutchinson, N_PROBES probes; the middle
    one must win), a timed fit at the chosen lambda to rtol 1e-10 on the
    inside points with y = sin(2 pi x) cos(2 pi y) + 0.2 eps (converged, true
    relative residual in f64 through the plain products <= 1e-8), predict at
    100,000 interior points (RMSE < 0.2 / 3); K2 and K6 launches read after
    it; the peak memory; then K2's sliced form on the products with P, Psi
    and Psi^T (k2_table: held to its plain version within the per-row
    bound, bitwise stable, equal to today's route, i.e. the (D, n) ELL,
    built here; timed with today's route, a torch.sparse CSR SpMV and the
    plain version against its bound; padding ratio printed), the same three
    at the sort windows SIGMAS (padding and time of each, results equal)
    and on a 16-column block stored either way (the Hutchinson block
    solve's products: each column equal to its vector launch, both timed),
    and one profiled fit's device busy share;
19. drive SpaceTimeSmoothing with the launch counts zeroed on a monitoring
    design, 2,000 sites x 365 daily times, over unit_square_mesh(256) (P1,
    66,049 dofs) and Interval(0, 1, 24) (cubic, 27 B-splines), lam_s = 1,
    lam_t = 0.1: fit at rtol 1e-10 converges, predict on a 100-site x
    7-time grid has RMSE < 0.06; whether the escalation fired and the K2
    launches printed; then solve_space_time_fdm on the model's
    (Mt, lam_t Pt, Ms, lam_s As + Ms) pencil agrees with the Kronecker CG
    (mode-diagonal preconditioner) on the same two-term operator to 1e-8
    relative, both at rtol 1e-12. k2_table on every product the fit and
    its right-hand side launch: each term's space factor on the transposed
    view of the (27, 66,049) iterate and its time factor on the row-major
    block (today's route: the I_c (x) A copies), Phi^T on the transposed
    view of Y and Psi^T on the row-major (2,000, 27) block; every block
    column equal to its vector launch bitwise; torch.sparse CSR as SpMM;
20. (after 13, on phase 12's mesh) the heat equation through
    PDE(mesh, dt() - laplacian(), times=linspace(0, 0.1, 11)) with
    u = sin(pi x) sin(pi y) e^-t (Dirichlet data and forcing per instant),
    rtol 1e-12, consistent and lumped mass, on the default "auto" ladder
    (the auxiliary grid at this size; Jacobi before it, ~1,620 iterations
    a step): every implicit-Euler step
    converges without the GMRES rerun, the max-over-time L2 error stays
    under dt / (4 (2 pi^2 - 1)) + 1e-5 (the first-order time error bound);
21. (a) PDE(mesh, -laplacian(), solver_preconditioner="amg") on phase 12's
    problem: converged without recovery, true residual <= 1e-10 as in phase
    12, equal to phase 12's aux-grid solution to 1e-8 max|x|, its host
    set-up, levels and operator complexity printed; K2 on every level's A,
    P and R = P^T against its plain version; the same solve on the host CPU
    (the hierarchy copied, K2's plain version) within 1 iteration of the
    card's and equal to 1e-10 max|x|; (b) the default ladder
    on a Delaunay surface lifted to z = 0.25 sin(pi x) sin(pi y) (22,801
    dofs, 3D dof coordinates) takes the rung the JAX package's ladder takes
    there on the CPU, the 3D aux grid (one AuxGridPreconditioner3D built,
    no AMG hierarchy, iterations within 10 % of JAX's 361), and converges;
    then the same surface with solver_preconditioner="amg" builds one AMG
    hierarchy and converges;
22. (after 15) bench.py's gen10m banded path through the model API:
    MatrixFreePoisson on irregular_mesh_device(3200) (lattice numbering,
    10,246,401 dofs) with "auto" reads "banded_mg", converges to 1e-9
    (true residual recomputed in f64 through the plain ELL product), twice
    bitwise equal; Jacobi CG rates of banded_cg on the float32 folded split
    and of CG on the float32 ELL (K2); MatrixFreeElliptic advection-
    diffusion at n = 1024 (split_plan (1025, 1)) through BiCGStab to 1e-9;
    that mesh's split at W + 1, whose remainder (on K2) is not empty, equal
    to the ELL's plain product within its per-row bound;
23. MatrixFreeParabolic: the banded route on phase 22's mesh at dt = 1e-7
    (~h^2), 5 steps at rtol 1e-9, chunked == unchunked bitwise; the
    aux-grid route on the scrambled relabelling of that mesh at dt = 1e-3,
    equal to the banded route's trajectory at that dt, relabelled, and one
    aux-grid step from u0 on the scrambled n = 800 mesh at dt = 1.6e-6 (dt /
    h^2 as at n = 3200 and 1e-7), converged within 1500 iterations; at
    n = 64 the banded trajectory equals solve_parabolic(lumped=True) to
    1e-10;
24. (after 23) bench.py's genp2 through the model API: FEMSpace(order=2)
    on phase 12's mesh (2,076,481 dofs; host seconds printed),
    MatrixFreeElliptic.from_space(K=1, c=1, max_degree=16) reads "auxgrid"
    (the band plan rejects P2's numbering), its ELL's shape and padding;
    load_vector(1) solved at rtol 1e-8 (chunk 6) converges, the true
    residual recomputed in f64 through the plain ELL product within 1e-8
    plus its rounding floor, twice bitwise equal; ELL @ v equals the port's
    assembled P2 matrix of -Laplace + 1 (assemble_matrix on the card) to
    1e-12 relative with the same entry count; K2 on the (49, n) P2 ELL
    with its warp widths (k2_ell_table: against its plain version within
    the per-row bound, == the launch without the widths, timed with and
    without them against CSR, plain and its bound), and k2_table on the
    assembled matrix (sliced form, the compact table padded to the longest
    row with and without its warp widths, CSR, plain); P2 reproduces
    u = x^2 + y^2 on delaunay_mesh(256) to 1e-8 max|u| at rtol 1e-10;
25. bench.py's gendel: a jittered 284^2 Delaunay base (seed 11) refined
    three times on the card (uniform_refine_device, Euler witness) to
    5,130,225 nodes and 10,251,392 cells, cell areas summing to 1 to 1e-12,
    base degrees kept and new nodes at 6 cells (3 on the boundary),
    renumbered by strip_order_binned(x, y, 5000);
    MatrixFreeElliptic(max_degree=12, gather_kernel="lane",
    aux_kernel="lane", preconditioner="auxgrid") reads "auxgrid+lane"
    with a LaneAuxGrid over lane_friendly_grid_n(n) cells (bandwidth and
    plan_split_width(bcap=16384) printed); its apply equals the plain
    composition with P z as a torch gather within 8 eps P|z| + 2 eps |z|
    (float32), K2 on its P within the per-row bound, the P stage timed
    against the plain gather it replaces, a torch.sparse CSR SpMV and its
    plain version; K2 on the (13, n) P1 ELL, the f32 table of the inner CG
    and the f64 one of the outer residuals, with their warp widths
    (k2_ell_table);
    the right-hand side where(bnd, 0, 1) / n solved at rtol 1e-8 (chunk 16)
    converges with the true residual recomputed in f64, twice bitwise
    equal;
26. bench.py's gen3d through the model API: cube_mesh_device_soa(128, 0.2)
    on the card (2,146,689 nodes, 12,582,912 tets, equal to
    cube_mesh_device's arrays); MatrixFreePoisson "auto" reads "banded_mg"
    with (W1, W2) = (129, 16,641), remainder nnz printed, the
    BandedMGPreconditioner3D set-up and levels printed; where(bnd, 0, 1) / C
    solved at rtol 1e-9 (f64 vectors, f32 V-cycle) converges with the true
    residual recomputed in f64 through the plain product of the (16, n) ELL
    within 1e-9 plus its rounding floor, twice bitwise equal; the split
    equals the ELL within the per-row bound; Jacobi CG rates of the f32
    folded split and the f32 ELL on K2; K2 on the (16, n) ELL in f64 and
    f32 with its warp widths (k2_ell_table); u = x + 2y - z reproduced to
    1e-9 max|u|;
27. a block-scrambled relabelling of phase 26's mesh through
    MatrixFreeElliptic(K=1, gather_kernel="lane", "auto"): "auxgrid+lane"
    with an AuxGridPreconditioner3D over 128^3 cells; its apply against the
    plain composition (P z as a torch gather) within the float32 bound, K2
    on its (8, n) P (compact) and its P^T (sliced) against their plain
    versions, timed against their bounds, the gather / index_add_ they
    replace, CSR and plain; load_vector(1) solved at rtol 1e-8 converges
    (true f64 residual within 1e-8 plus its floor), twice bitwise equal,
    and equal, relabelled, to the lattice numbering's banded solution to
    1e-6 max|x|; MatrixFreeParabolic at n = 64 (274,625 dofs), dt = 1e-3,
    5 steps on the banded route (lattice) and the aux-grid route
    (scrambled): trajectories equal, relabelled, to 1e-8; PDE(unit_cube_
    mesh(32)) (35,937 dofs) through the default ladder takes the 3D aux
    grid (as the JAX package's does) and reproduces u = x + 2y - z to 1e-9;
28. solve_semilinear (BASELINE configuration 4, -Lap u + u^3 = f with
    u = sin(pi x) sin(pi y)) on phase 12's mesh (519,841 dofs): f from
    fields (-trace of ScalarField.derive_twice(mode="auto") + u^3, vmapped
    over the quadrature points on the card) equals 2 pi^2 u + u^3 to 1e-12;
    Newton in <= 8 steps, last residual < 1e-10, max error below
    SEMILINEAR_BOUND, K2's sliced layout built once, K6 launched; then the
    forced BFGS fallback (max_newton=1, newton_tol=1e-30, H = v^4 / 4) on
    unit_square_mesh(N_BFGS): method "bfgs_fallback", equal to Newton to
    1e-4, K2's backward launched;
29. mixed Dirichlet/Neumann data (BASELINE configuration 2, JAX's
    test_mixed_bc_quadratic_solution: u = x^2, du/dn = 2 on x = 1) on phase
    12's mesh through solve_elliptic at rtol 1e-13: P1 within
    NEUMANN_P1_BOUND (K6 launched), P2 on phase 24's space (2,076,481
    dofs) to 1e-9; assemble_neumann(1, whole boundary) sums to 4 and
    integrate(mesh, 1) to 1, both to 1e-12; the host FEMSpace(order=2) with
    the native hash pass (built with g++ here) and with the NumPy sort,
    both timed, their edges and dof tables equal;
30. cg_differentiable on phase 12's mesh: d|u(kappa) - target|^2 / dkappa
    (matvec = kappa A + M, Jacobi-preconditioned) equals its central
    difference to 1e-4 relative, the adjoint solve within 20 % of the
    forward's iterations, K2's backward launched; a directional derivative
    in the (nnz,) values of a weighted mass matrix equals the same
    gradient through K2's plain version on the card to 1e-10 relative and
    its central difference to 1e-4; K2's backward product (A^T v on the
    transpose's sliced form) against its plain version within the per-row
    bound, timed against the forward on the same table, CSR and its bound;
    the inverse problem (kappa* = 3 by optimization.newton, its Hessian
    through the solve) on delaunay_mesh(N_INVERSE) to 1e-6; the FSPAI rung
    of the recovery step on delaunay_mesh(N_FSPAI) (Jacobi CG stopped by
    FSPAI_MAXITER): the warning names FSPAI, the set-up took the native
    library once (host seconds and L's nnz printed), GMRES(50) converges
    with a true residual <= 1e-9;
31. the last single-device modules at full size: (a) a street network,
    phase 12's jittered lattice joined by its horizontal and vertical
    segments (519,841 junctions, 1,038,240 segments), through
    PDE(LinearNetwork(...)) with the default ladder at rtol NETWORK_RTOL:
    constant data 2.5 reproduced to 1e-10 and g = x + y within its range +- 1e-8, both on the
    2D aux grid as in JAX, the true residual recomputed in f64 <= 1e-8,
    utils.profiling.timer(sync=) reading at least the CUDA-event time of
    the same solve; K2 on the network's stiffness (k2_table); at
    NX_NETWORK_SMALL JAX's rung and iterations within 10 % of
    NETWORK_JAX_RUNG; (b) Interval(0, 1, 2^17) P1 and (since PR 12)
    Interval(0, 1, 2^15) P2 through the
    default ladder: the aux grid's build raises on 1-column coordinates and
    SA-AMG converges without recovery, P1's error <= 1e-11 and iterations
    within 10 % of INTERVAL_JAX_RUNG; u = x on unit_interval_mesh(2^17) to
    1e-9; (c) phase 21a's SA-AMG hierarchy through save_amg / load_amg on
    the card (V-cycle bitwise; PDE(solver_preconditioner=loaded.v_cycle)
    takes phase 21a's iterations and solution bitwise) and phase 12's P1
    FEMSpace through save_space / load_space (assemble_matrix through K6
    bitwise), seconds beside the set-up's; (d) delaunay_mesh(256)'s
    stiffness written as an R-style 1-indexed COO CSV and read by
    read_csv_sparse onto the card (rows, cols, vals and K2's product
    bitwise, Jacobi CG to 1e-10), the mesh through load_mesh_csv, read_mtx
    of unit_square_mesh(32)'s matrix against its dense form; (e)
    assert_all_finite over the phase's solutions, sanitize.checked raising
    on a masked NaN and on one out of K2 and passing clean code, and an
    xprof_trace of a network solve whose CUDA kernels include K2's.
    Phases 20-31 print their seconds and K2 / K6 launches by path;
32. the multi-device layer (parallel/) in a one-rank NCCL group
    (init_world: HashStore, rank 0 of 1, cuda:0; every psum and all_gather
    an NCCL launch): the collectives timed against no group;
    ShardedPoisson on phase 12's mesh (segment, ell: Jacobi at 1e-10
    against solve_elliptic's Jacobi CG; auxgrid at 1e-12 against phase
    12's PDE); solve_elliptic_sharded (halo_dia) and HaloGridDIASolver at
    1e-8 on unit_square_mesh(N_DIA) against phase 16, HaloDIAParabolic
    over PARA_STEPS steps against solve_parabolic; P2 on
    unit_square_mesh(N_SHARDED_P2) after RCM (K and H before and after)
    against solve_elliptic; ShardedGridMG on the n = N_MAIN operator from
    K1 (f64) against phase 4 (<= 15 iterations); HaloELLSolver on
    irregular_mesh_device_soa(N_HALO_ELL) against Jacobi CG on K2;
    ShardedBandedMGSolver on gen10m's folded split against phase 22;
    HaloLaneSolver with the distributed aux grid on genscat against phase
    8 (iterations within 2x + 2 of its inner ones); ShardedSpaceTime on
    phase 19's fit operator, solve_space_time_fdm(device_mesh=) against
    phase 19's FDM (bitwise); dryrun_multichip at N = 1 (12 paths). Each
    solution is held to 2 kappa rtol max|x| of its single-device twin
    (kappa = 4 n^2 / pi^2, see kappa_p1) and its iterations to 10 %; K7 on
    the halo-padded table and K2 on the halo-extended one (with the
    shard's warp widths, == the launch without) against their plain
    versions (per-row bound), timed beside torch.sparse CSR; K2, K6 and K7
    launches by path. The solves of phases 8, 24, 25, 26 and 32's
    HaloELLSolver take ITERATIONS_KEPT's counts.
33. hold the V-cycle's coarse-solve kernel KC (64 CG iterations in one
    launch) against the plain loop on the main path's coarsest level (m =
    51, K = 9) in f32 and f64 (relative gap 1e-5 / 1e-12, also after one
    iteration; a zero right-hand side gives x = 0; bitwise stable), its
    launch count zeroed just before, and time both with CUDA events.
34. time the V-cycle's finer-level stage kernels (csrc/grid_mg_levels.cu:
    the Jacobi sweep from x and from x = 0, the residual, the
    restriction, the prolongation with its correction) with CUDA events
    at the main paths' level shapes (3201^2 f32 K = 5, the aux grid's
    level 0; 3201^2 f32 K = 9, the banded level 0; 1601^2 f32 K = 9;
    721^2 f64 K = 5, the pde cell's aux level 0) against their bytes
    bound (each input read once, each output written once, 3.35 TB/s),
    the plain stage and their launch counts (one a stage); hold each
    stage and a whole V-cycle on a hierarchy from each shape bitwise to
    the plain ones; report the wrappers' host microseconds a launch.

Phases 4-32 count their V-cycle coarse solves: KC's launches, and those
of card vectors that took the plain loop; and log the stage kernels'
launches. Phases 4, 5, 8, 9, 10, 12, 22
and 32 run a 2D GridMG on the card, so each must launch KC and take the
plain loop for none; checked after the last phase.

Prints one JSON line of per-kernel results (each with its bound on the
card from this run's shapes: bytes over 3.35 TB/s or operations over the
type's peak, whichever is larger, but KC's, a latency bound, kc_bound_ms;
KC's launches by phase under "launches_by_phase"; K2's entry is the compact (9, 10.25M)
ELL of phase 7 with its warp widths ("full_ms" without them), the P2
and gendel ELLs with and without their widths under "compact", float32
values against a float64 x under "mixed" (with that kernel's launches
in phases 8-32), with the sliced form on phase
18's Psi^T under "sliced",
the 3D ELL of phase 26 under "ell_3d", the 3D aux grid's P and P^T of
phase 27 under "aux_3d", the launches of its backward in phases 28-30
under "launches_backward" and phase 30's backward product under
"backward"; K2, K6, K7 and KC carry phase 32's launches by path under
"launches_sharded", K2 and K7 their halo forms under "halo"),
then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device or
without the package beside it.
"""

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

N_MAIN = 3200
N_ODD = 257  # not a multiple of 128
N_HARMONIC = 256
CG_ITERS = 500
SEED = 1234
DEVICE = "cuda"
SCRAMBLE = (4096, 1361)  # block size S and multiplier G (coprime) at n = 3200
SCRAMBLE_SMALL = (512, 397)  # at n = 256
NX_PDE = 720  # bench.py's `general` group at full size (bench.py:695-705)
N_OBS = 2_000_000  # phase 17's query points, phase 18's observations (those inside)
SIGMA = 0.2  # phase 18's noise
# phase 18's lambda grid: GCV's minimum sits near 50 at this size
# (examples/torch_data_fitting_scaling.py gcv puts it near 3 at nx = 90
# and near 8 at nx = 180; it grows like n^(2/3)), so the middle one wins by
# a wide margin on either side
LAMBDAS = (2.5, 50.0, 1000.0)
N_PROBES = 8
N_ST_MESH, N_SITES, N_DAYS = 256, 2000, 365  # phase 19's monitoring design
LAM_S, LAM_T = 1.0, 0.1
SLEEP_CYCLES = 20_000_000  # time_ms's head start for the host: ~10 ms at the H100's clock
KC_THREADS = 512  # kThreads of csrc/grid_coarse_cg.cu
SIGMAS = (1, 256, 1024, 4096)  # the sort windows phase 18 times K2's sliced form at
N_DIA = 1024  # the DIA path's unit_square_mesh: 1,050,625 dofs, 2,097,152 cells
T_HEAT = np.linspace(0.0, 0.1, 11)  # phase 20's instants
NX_SURFACE = 150  # phase 21b's lifted surface: 22,801 dofs
# the JAX package's default ladder on that surface, run on the CPU: the 3D
# aux grid rung (AuxGridPreconditioner3D over the 3D dof coordinates) and
# its CG iterations at rtol 1e-12
SURFACE_JAX_RUNG = ("auxgrid 3D", 361)
N_GEN1M = 1024  # phase 22's advection-diffusion mesh (bench.py:1417-1447): 1,050,625 dofs
CG_RATE_ITERS = 40  # phase 22's Jacobi CG rate runs (bench.py's ITERS)
DT_MF, N_STEPS_MF = 1e-7, 5  # phase 23: dt ~ h^2 at n = 3200
DT_AUX = 1e-3  # phase 23's aux-grid route, where A dominates M / dt
# phase 23's one aux-grid step at dt ~ h^2: its iterations grow with n
# (the grid stencil is the unshifted Laplacian, as in JAX). At n = 3200 and
# DT_MF it took 1,114 iterations in 85.1 s, at n = 1600 and 4e-7 750 in
# 45.4 s (~60-76 ms an iteration; NVIDIA H100 80GB HBM3, 700 W, the whole
# script); since PR 12 it runs on the scrambled n = N_AUX_H2 mesh at the
# same dt / h^2, to keep the script near half its time limit with the
# multi-device phase 32 added
N_AUX_H2 = 800
DT_AUX_H2 = DT_MF * (N_MAIN / N_AUX_H2) ** 2
AUX_H2_MAXITER = 1500
P2_DOFS = 2_076_481  # phase 24: FEMSpace(order=2) on phase 12's mesh (bench.py's genp2)
P2_MAX_DEGREE = 16
N_P2_QUADRATIC = 256  # phase 24's quadratic reproduction mesh
# phase 25 (bench.py's gendel, :1561-1611): a 284^2 jittered Delaunay base
# (seed 11) red-refined three times on the card, then strip-renumbered
NX_GENDEL, GENDEL_SEED, GENDEL_LEVELS, GENDEL_POP = 283, 11, 3, 5000
GENDEL_SIZES = (5_130_225, 10_251_392, 9_056)  # nodes, cells, boundary nodes
# phases 26-27 (bench.py's gen3d, :1988-2142): the jittered Freudenthal cube
N_GEN3D = 128
GEN3D_SIZES = (2_146_689, 12_582_912)  # nodes, tets
GEN3D_ITERS = 10  # the Jacobi CG rate runs (bench.py's ITERS)
N_PARA3D, DT_PARA3D, STEPS_PARA3D = 64, 1e-3, 5  # phase 27's MatrixFreeParabolic: 274,625 dofs
N_CUBE_PDE = 32  # phase 27's PDE on unit_cube_mesh: 35,937 dofs
# phase 28: the P1 max error of -Lap u + u^3 = f (u = sin pi x sin pi y)
# on delaunay_mesh(nx), measured on the CPU at nx = 24, 48, 96, is at most
# 0.479 h^2 ln(1/h); the bound is twice that at nx = 720
SEMILINEAR_BOUND = 2 * 0.479 * np.log(NX_PDE) / NX_PDE ** 2
# the largest unit_square_mesh at which the forced BFGS fallback agreed with
# Newton to 1e-4 within 500 iterations on the CPU (1.8e-8 at 96; 128 was not
# tried there: its dense inverse Hessian is 2.2 GB)
N_BFGS = 96
# phase 29: the P1 max error of the mixed problem u = x^2 on
# delaunay_mesh(nx) is at most 0.0754 h^2 ln(1/h) on the CPU (nx = 24, 48,
# 96); twice that at nx = 720. P2 takes Jacobi CG: on the CPU it needed
# 573, 1,138, 2,222 iterations at nx = 48, 96, 192 to rtol 1e-13 (the aux
# grid 107, 189, 263, each a launch-bound V-cycle on the card)
NEUMANN_P1_BOUND = 2 * 0.0754 * np.log(NX_PDE) / NX_PDE ** 2
# phase 30: the inverse problem's mesh, cut from nx = 720 for the time
# budget (10 Newton steps, 124 solves, CG iterations ~ nx): newton took
# 5.0, 9.2, 14.2 and 19.6 s at nx = 64, 128, 192 and 256 (NVIDIA H100 80GB
# HBM3, 700 W, inverse_problem below), and 31.3 s at 256 in the whole
# script; 128 makes room for phase 31 (151 s alone on the same card)
N_INVERSE = 128
# the FSPAI rung's mesh: the masked Laplacian's native FSPAI set-up took
# 3.2 s at nx = 150 and 14.5 s at nx = 300 (90,601 dofs) on a shared CPU;
# maxiter leaves Jacobi CG short of 1e-10 and GMRES(50) maxiter / 50 cycles
N_FSPAI, FSPAI_MAXITER = 300, 500
# phase 31 (a): the street network of phase 12's lattice, and the same
# construction at NX_NETWORK_SMALL (25,921 junctions), where the JAX
# package's default ladder on the CPU (PDE(LinearNetwork(...)), g = x + y,
# f = 0, rtol 1e-12; a scratch run, JAX_PLATFORMS=cpu) built the 2D aux
# grid and took 168 CG iterations; the port's ladder on the CPU
# (PDE(LinearNetwork(*street_network(nx)), ..., device="cpu")) took the
# same rung and count, and 218 iterations at nx = 320
NX_NETWORK_SMALL = 160
# the error of the constant is about kappa * rtol * 2.5: at nx = NX_PDE, rtol
# 1e-12 left 4.06e-10 (NVIDIA H100 80GB HBM3, 700 W), at nx = 160 on the CPU
# 7.2e-11 against 7.6e-12 at 1e-13, so the full-size network solves run at
# 1e-13
NETWORK_RTOL = 1e-13
NX_NETWORK_TRACE = 32  # (e): the network solve traced by xprof_trace (Jacobi CG)
NETWORK_JAX_RUNG = ("auxgrid", 168)
# (b) 1D P1 on Interval(0, 1, N_INTERVAL) (131,073 dofs), -u'' = pi^2
# sin(pi x): the JAX package's ladder on the CPU raised in the aux grid's
# build (1-column coordinates) and took SA-AMG, 1,089 CG iterations, max
# error 2.8e-13; its iterations grow about linearly with n (235 at 32,769
# dofs), a fault of the reference that the port reproduces (the port's
# ladder on the CPU: 1,075 iterations, error 2.4e-12)
N_INTERVAL = 2 ** 17
# 1D P2 at 2^17 cells took 3,225 iterations in 21.2-28.9 s (NVIDIA H100
# 80GB HBM3, 700 W; PR 11); since PR 12 it runs at 2^15, where phase 32 took
# that time
N_INTERVAL_P2 = 2 ** 15
INTERVAL_JAX_RUNG = ("amg", 1089)
N_IO_MESH = 256  # (d): delaunay_mesh(256), 66,049 dofs
# the iterations these solves took on the card with K2's compact form
# reading every slot (NVIDIA H100 80GB HBM3, 700 W): reading each warp's
# slots only to its width changes no sum, so the counts stay
ITERATIONS_KEPT = {"genscat": 75, "P2": 23, "gendel": 128, "gen3d": 10, "HaloELLSolver": 2920}
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the vector (non-tensor
# core) peaks of the types these kernels compute in
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 67e12}
# operations per cell of the closed forms (b, c, det, 1/(2|det|), 4 per
# unique entry); K3: per quad, 8 edge differences and two triangles' three
# off-diagonal entries (22 each)
OPS_PER_CELL = {"K6": 40, "K4": 35, "K5": 23}
OPS_PER_QUAD_K3 = 52


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def perturbed_planes(n, dtype, gen, shape=None, junk=7.0):
    """Coordinate planes of the unit-square grid, interior nodes jittered by
    +-0.1 h from a seeded generator on the card; node (i, j) at row i,
    column j; any rows/columns beyond n hold `junk`."""
    m = n + 1
    kw = dict(dtype=dtype, device=DEVICE)
    gi = torch.arange(m, **kw)[:, None]
    gj = torch.arange(m, **kw)[None, :]
    interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n)).to(dtype)
    jitter = (torch.rand((2, m, m), generator=gen, **kw) - 0.5) * 0.2 * interior
    rows, cols = shape or (m, m)
    X = torch.full((rows, cols), junk, **kw)
    Y = torch.full((rows, cols), junk, **kw)
    X[:m, :m] = (gi + jitter[0]) / n
    Y[:m, :m] = (gj + jitter[1]) / n
    return X, Y


def time_ms(fn, reps):
    """Mean device milliseconds per call over `reps` calls, after a warm-up.
    The card first sleeps (~10 ms) while the host queues the calls, so a
    call shorter than its launch on the host is timed on the device alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def least_time(nbytes, ops, dtype):
    """The least time the card could take: bytes moved (each input read and
    each output written once) over HBM bandwidth, or operations over the
    type's peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(what, fn):
    """Run fn once under torch.profiler; print its host seconds, the device
    busy time and share, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = synced_seconds(fn)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"profiled {what}: the profiler recorded no device events (idle share not measured)")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"profiled {what}: {t_prof:.4f} s on the host clock, {len(kernels)} device "
        f"events, device busy {busy:.4f} s ({100 * busy / t_prof:.1f} %); top by device time: "
        + "; ".join(f"{name[:60]} {sec:.4f} s" for name, sec in top))


def phase_kernel_vs_plain(ak):
    """K1 against its plain version; returns the main-shape measurements."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tol_of = lambda ref: 8 * torch.finfo(ref.dtype).eps * ref.abs().max().item()  # noqa: E731

    # padded layout on junk planes, n not a multiple of 128, f32 and f64
    for dtype in (torch.float32, torch.float64):
        W = -(-(N_ODD + 1) // 128) * 128
        X, Y = perturbed_planes(N_ODD, dtype, gen, shape=(N_ODD + 8, W))
        got = ak.p1_stencil_layers_from_coords(X, Y, N_ODD)
        ref = ak.p1_stencil_layers_from_coords_reference(X, Y, N_ODD)
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), tol_of(ref)
        log(f"K1 n={N_ODD} {dtype} padded: max|kernel-plain| = {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"K1 n={N_ODD} {dtype} disagrees with its plain version")
        check(torch.equal(got, ak.p1_stencil_layers_from_coords(X, Y, N_ODD)),
              "K1 is not bitwise stable from run to run")

    # the main path's shapes: (m, m) planes -> compact (7, m, m) layers
    n, m = N_MAIN, N_MAIN + 1
    X, Y = perturbed_planes(n, torch.float32, gen)
    out = torch.empty((7, m, m), dtype=torch.float32, device=DEVICE)
    ak.p1_stencil_layers_into(X, Y, n, out)
    ref = ak.p1_stencil_layers_from_coords_reference(X, Y, n)[:, 7:7 + m, :m]
    torch.cuda.synchronize()
    err, tol = (out - ref).abs().max().item(), tol_of(ref)
    log(f"K1 n={n} float32 compact: max|kernel-plain| = {err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"K1 n={n} float32 disagrees with its plain version")
    check(torch.isfinite(out).all().item(), "K1 produced non-finite layers")

    kernel = lambda: ak.p1_stencil_layers_into(X, Y, n, out)  # noqa: E731
    plain = lambda: ak.p1_stencil_layers_from_coords_reference(X, Y, n)  # noqa: E731
    k1, p1 = time_ms(kernel, 50), time_ms(plain, 5)
    k2, p2 = time_ms(kernel, 50), time_ms(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    cells = 2 * n * n
    # reads the X, Y planes, writes 7 layers; every cell's closed form plus
    # six adds per stencil entry
    b = least_time(9 * m * m * 4, cells * OPS_PER_CELL["K6"] + 6 * 7 * m * m, torch.float32)
    log(f"K1 n={n} float32: kernel {k1:.4f} / {k2:.4f} ms "
        f"({cells / (ms * 1e-3):.4e} elements/s), plain {p1:.4f} / {p2:.4f} ms "
        f"({cells / (plain_ms * 1e-3):.4e} elements/s); bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def zero_launch_counts(ak, gs):
    """Set every kernel wrapper's launch count to 0."""
    from fdapde_core_tpu_torch.ops import dia_spmv as ds
    from fdapde_core_tpu_torch.ops import local_stiffness as ls

    ak.p1_stencil_launches = 0
    ak.p1_offdiag_planes_launches = 0
    ds.dia_spmv_launches = 0
    gs.ell_spmv_launches = 0
    ls.p1_stiffness_2d_launches = 0
    ls.p1_stiffness_edges_launches = 0
    ls.p1_stiffness_edges_offdiag_launches = 0
    gs.ell_spmv_backward_launches = 0


def phase_main_path(ak, gs, StructuredPoisson):
    """StructuredPoisson(3200) end to end; returns (model, launches)."""
    zero_launch_counts(ak, gs)
    model = StructuredPoisson(N_MAIN, dtype=torch.float32, device=DEVICE)
    G, t_op = synced_seconds(model.operator)
    mg, t_mg = synced_seconds(model.multigrid)
    b = model.rhs()
    (x, rel, k), t_solve = synced_seconds(lambda: model.solve(b, rtol=1e-9, maxiter=60))
    launches = ak.p1_stencil_launches

    log(f"main path n={N_MAIN}: operator {t_op:.4f} s, multigrid {t_mg:.4f} s, "
        f"solve {t_solve:.4f} s; {k} iterations, true rel residual {rel.item():.4e}; "
        f"K1 launches {launches}")
    check(launches > 0, "the main path never launched the K1 kernel")
    check(G.offsets2d == ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)),
          f"pruned offsets {G.offsets2d} are not the uniform 5-point stencil")
    check(mg.shapes == (3201, 1601, 801, 401, 201, 101, 51), f"MG levels {mg.shapes}")
    check(x.dtype == torch.float64 and x.shape == (model.m * model.m,), "solution dtype/shape")
    check(torch.isfinite(x).all().item(), "non-finite solution")
    # independent true residual through GridDIAMatrix.__matmul__
    b64 = b.to(torch.float64)
    r = b64 - G @ x
    rel_check = (torch.linalg.norm(r) / torch.linalg.norm(b64)).item()
    log(f"main path: recomputed true rel residual {rel_check:.4e}")
    check(rel.item() <= 1e-8 and rel_check <= 1e-8, "MG-CG did not reach 1e-8")
    check(k <= 15, f"MG-CG took {k} > 15 iterations")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    TWINS["structured"] = (x.cpu(), k)
    return model, launches


def phase_harmonic(StructuredPoisson):
    n = N_HARMONIC
    model = StructuredPoisson(n, dtype=torch.float64, device=DEVICE)
    t = torch.arange(n + 1, dtype=torch.float64, device=DEVICE) / n
    g = (t[:, None] + t[None, :]).reshape(-1)
    x, rel, k = model.solve(b=model.rhs(0.0, g=g), rtol=1e-11, maxiter=60)
    err = (x - g).abs().max().item()
    log(f"harmonic n={n} float64: max|x - g| = {err:.3e} ({k} iterations, rel {rel.item():.3e})")
    check(err < 1e-10, "harmonic data not reproduced to 1e-10")


def phase_jacobi(model, grid_cg):
    G = model.operator()
    b = model.rhs()
    for data_dtype in (None, torch.bfloat16):
        grid_cg(G, b, 5, data_dtype=data_dtype)  # warm-up
        (x, res), dt = synced_seconds(lambda: grid_cg(G, b, CG_ITERS, data_dtype=data_dtype))
        name = "float32" if data_dtype is None else "bfloat16"
        log(f"Jacobi CG n={N_MAIN} {name} data: {CG_ITERS / dt:.2f} iterations/s, |r| = {res.item():.4e}")
        check(torch.isfinite(res).item() and torch.isfinite(x).all().item(), "Jacobi CG non-finite")


def scrambled_mesh(n, S, G):
    """The irregular n x n mesh (f64, on the card) with its nodes relabelled
    block-locally, i -> (i // S) * S + (G * (i % S)) % S (the trailing
    partial block keeps its ids): the scattered numbering that the band
    plan rejects. Returns (x, y, cells (C, 3) int32, boundary)."""
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device_soa

    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(n, 0.2, dtype=torch.float64, device=DEVICE)
    p, pinv = scramble_perm(x.shape[0], S, G)
    cells = p[torch.stack([c0, c1, c2], dim=1).long()].to(torch.int32)
    return x[pinv], y[pinv], cells, bnd[pinv]


def scramble_perm(nd, S, G):
    """(p, pinv) of scrambled_mesh's relabelling: lattice node i becomes
    node p[i]; scrambled node k is lattice node pinv[k]."""
    nfull = (nd // S) * S
    i = torch.arange(nd, device=DEVICE)
    p = torch.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    pinv = torch.where(i < nfull, (i // S) * S + (pow(G, -1, S) * (i % S)) % S, i)
    return p, pinv


def ell_nnz(E):
    """Stored entries of an ELLSoA: its padding carries col = row after the
    row's entries, and every row holds its diagonal."""
    K, n = E.vals.shape
    rows = torch.arange(n, dtype=E.cols.dtype, device=E.cols.device)
    return K * n - (int((E.cols == rows[None, :]).sum()) - n)


def ell_csr(V, C, pad=None, n_src=None):
    """A torch.sparse CSR tensor of a compact (K, n) ELL's stored entries:
    the padding (col = pad, by default the row, after the row's first entry
    in that column) is left out. n_src: the operand's length (default n)."""
    n = V.shape[1]
    if pad is None:
        pad = torch.arange(n, dtype=C.dtype, device=C.device)
    diag = C == pad[None, :]
    keep = (~diag | (torch.cumsum(diag, 0) == 1)).T
    crow = torch.zeros(n + 1, dtype=torch.int64, device=C.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow, C.T[keep].long(), V.T[keep], (n, n_src or n),
                                   check_invariants=False)


def slots_read(gs, warp_w, n):
    """The slots K2's compact form reads with these warp widths: each of
    the n rows its warp's width."""
    w = warp_w.long()
    if w.numel() == 0:
        return 0
    return gs.WARP * int(w.sum()) - (w.numel() * gs.WARP - n) * int(w[-1])


def k2_compact_check(gs, name, V, C, x, warp_w=None):
    """K2's compact form on the (K, n) table (V, C) at x, with warp widths
    where given, against its plain version (every slot) within the per-row
    bound K eps(acc) sum_k |v x|, bitwise stable, and with widths equal
    (torch.equal) to the launch without them. Returns (max|kernel -
    plain|, max err / bound)."""
    acc = x.dtype
    got, ref = gs.ell_spmv(V, C, x, warp_w), gs.ell_spmv_reference(V, C, x)
    bound = V.shape[0] * torch.finfo(acc).eps * gs.ell_spmv_reference(V.abs(), C, x.abs())
    err = (got - ref).abs()
    check(bool((err <= bound).all()), f"K2 on {name} disagrees with its plain version")
    check(bool(torch.isfinite(got).all()), f"K2 on {name} produced non-finite values")
    check(torch.equal(got, gs.ell_spmv(V, C, x, warp_w)), f"K2 on {name} is not bitwise stable")
    if warp_w is not None:
        check(torch.equal(got, gs.ell_spmv(V, C, x)),
              f"K2 on {name} with its warp widths differs from the launch without them")
    return err.max().item(), (err / bound.clamp_min(torch.finfo(acc).tiny)).max().item()


def phase_k2_vs_plain(gs):
    """K2 against its plain version on the scrambled n = 3200 ELL; returns
    the float32 measurements."""
    from fdapde_core_tpu_torch.ops.matfree_soa import MatrixFreeSoA

    x, y, cells, _ = scrambled_mesh(N_MAIN, *SCRAMBLE)
    nd = x.shape[0]
    op, over = MatrixFreeSoA.build(x, y, *cells.T.contiguous(), nd, 8)
    check(not bool(over), "scrambled mesh exceeds 8 cell incidences")
    E64, overc = op.to_ell(9)
    check(not bool(overc), "scrambled ELL exceeds 9 columns")
    del op, x, y, cells
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    K, n = E64.vals.shape
    n_rect, n_src = n - 77, n + 333  # n_rect is not a multiple of the 256-row block
    W = E64.warp_w
    check(W is not None, "the scrambled ELL came without its warp widths")
    cases = {
        "float32": (E64.vals.float(), E64.cols, n, torch.float32, W),
        "float64": (E64.vals, E64.cols, n, torch.float64, W),
        "bfloat16": (E64.vals.bfloat16(), E64.cols, n, torch.float32, W),
        "float32 values, float64 x": (E64.vals.float(), E64.cols, n, torch.float64, W),
        "float32 rectangular": (
            E64.vals[:, :n_rect].float().contiguous(),
            ((E64.cols[:, :n_rect].long() * 7 + 3) % n_src).to(torch.int32).contiguous(),
            n_src, torch.float32, None,
        ),
    }
    read, nnz = slots_read(gs, W, n), ell_nnz(E64)
    out = {}
    for name, (V, C, src, acc, ww) in cases.items():
        xv = torch.rand(src, generator=gen, dtype=torch.float64, device=DEVICE).to(acc) - 0.5
        err, ratio = k2_compact_check(gs, name, V, C, xv, ww)
        log(f"K2 {name} ({V.shape[0]}, {V.shape[1]}) n_src={src}"
            f"{'' if ww is None else ', with its warp widths'}: max|kernel-plain| = "
            f"{err:.3e}, max err/bound = {ratio:.3e}")
        if name == "float32 values, float64 x":
            # the float64 launch on the converted table, as ELLSoA @ ran
            # before the kernel widened float32 values itself
            convert = lambda: gs.ell_spmv(V.double(), C, xv, W)  # noqa: E731
            same = torch.equal(gs.ell_spmv(V, C, xv, W), convert())
            check(same, "K2 on float32 values and a float64 x differs from the converted table's")
            m1, c1 = time_ms(lambda: gs.ell_spmv(V, C, xv, W), 50), time_ms(convert, 50)
            m2, c2 = time_ms(lambda: gs.ell_spmv(V, C, xv, W), 50), time_ms(convert, 50)
            log(f"K2 {name} n={N_MAIN}: == the float64 launch on the converted table: {same}; "
                f"kernel {m1:.4f} / {m2:.4f} ms, conversion + float64 kernel {c1:.4f} / {c2:.4f} ms")
            out[name] = dict(max_abs_err=err, ms=(m1 + m2) / 2, convert_ms=(c1 + c2) / 2)
        if name in ("float32", "float64"):
            ref = gs.ell_spmv_reference(V, C, xv)
            # the same product as one library call: a CSR SpMV through
            # torch.sparse on the table's stored entries (timed, never used)
            csr = ell_csr(V, C)
            lib_err = (csr @ xv - ref).abs().max().item()
            kernel = lambda: gs.ell_spmv(V, C, xv, W)  # noqa: E731
            full = lambda: gs.ell_spmv(V, C, xv)  # noqa: E731
            plain = lambda: gs.ell_spmv_reference(V, C, xv)  # noqa: E731
            library = lambda: csr @ xv  # noqa: E731
            k1, f1, p1, l1 = (time_ms(kernel, 50), time_ms(full, 50), time_ms(plain, 5),
                              time_ms(library, 50))
            k2, f2, p2, l2 = (time_ms(kernel, 50), time_ms(full, 50), time_ms(plain, 5),
                              time_ms(library, 50))
            ms, plain_ms, library_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
            del csr
            # the bound on the entries the table stores; the slots the
            # kernel reads (its warps' widths) give a second, labelled one
            vb, xb = V.element_size(), xv.element_size()
            nbytes = nnz * (vb + 4) + 2 * n * xb
            b = least_time(nbytes, 2 * nnz, V.dtype)
            b_read = least_time(read * (vb + 4) + 2 * n * xb, 2 * read, V.dtype)
            log(f"K2 {name} n={N_MAIN}: kernel with warp widths {k1:.4f} / {k2:.4f} ms "
                f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes / 1e9:.3f} GB for its {nnz} "
                f"stored entries; {read / nnz:.4f} slots read per entry with the widths, "
                f"{K * n / nnz:.4f} without), without {f1:.4f} / {f2:.4f} ms, plain {p1:.4f} / "
                f"{p2:.4f} ms, torch.sparse CSR of the stored entries {l1:.4f} / {l2:.4f} ms "
                f"(max|csr-plain| {lib_err:.3e}); bound on the stored entries "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {100 * b['bound_ms'] / ms:.0f} %), "
                f"on the {read} slots read {b_read['bound_ms']:.4f} ms "
                f"({100 * b_read['bound_ms'] / ms:.0f} %)")
            out[name] = dict(max_abs_err=err, ms=ms, full_ms=(f1 + f2) / 2, plain_ms=plain_ms,
                             library_ms=library_ms, slots_per_entry=read / nnz,
                             read_bound_ms=b_read["bound_ms"], **b)
    return out["float32"], out["float32 values, float64 x"]


def true_rel_residual(E, bnd, x, b_mod, gs):
    """||b_mod - A~ x|| / ||b_mod|| with the Dirichlet-masked operator
    applied through the plain SpMV in f64."""
    free = (~bnd).to(torch.float64)
    Ax = gs.ell_spmv_reference(E.vals.double(), E.cols, x * free) * free + x * bnd
    return (torch.linalg.norm(b_mod - Ax) / torch.linalg.norm(b_mod)).item()


def aux_pt_table(gs, name, aux):
    """The aux grid's P^T, K2's sliced form in float32: against its plain
    version within width eps P^T|r| (the weights are >= 0), bitwise stable;
    timed beside the index_add_ it replaces (atomics), a cuSPARSE CSR SpMV
    of P^T (timed, never used), its plain version and its bound. Returns
    the measurements."""
    PT = aux.PT
    r = torch.rand(PT.shape[1], generator=torch.Generator(device=DEVICE).manual_seed(SEED + 10),
                   dtype=torch.float32, device=DEVICE) - 0.5
    got, ref = PT @ r, gs.sliced_ell_spmm_reference(PT, r)
    bound = PT.width * torch.finfo(torch.float32).eps * gs.sliced_ell_spmm_reference(PT, r.abs())
    err = (got - ref).abs()
    check(bool((err <= bound).all()), f"K2 sliced on the {name}'s P^T disagrees")
    check(torch.equal(got, PT @ r), f"K2 sliced on the {name}'s P^T is not bitwise stable")
    m2, nnz = PT.shape[0], aux.idx.numel()
    scatter = lambda: torch.zeros(m2, dtype=r.dtype, device=DEVICE).index_add_(  # noqa: E731
        0, aux.idx.reshape(-1), (aux.w * r[None, :]).reshape(-1))
    ids = aux.idx.reshape(-1).long()
    order = torch.sort(ids, stable=True).indices
    crow = torch.zeros(m2 + 1, dtype=torch.int64, device=DEVICE)
    crow[1:] = torch.cumsum(torch.bincount(ids, minlength=m2), 0)
    csr = torch.sparse_csr_tensor(crow, order % r.shape[0], aux.w.reshape(-1)[order],
                                  (m2, r.shape[0]), check_invariants=False)
    del ids, order
    lib_err = (csr @ r - ref).abs().max().item()
    t_pt, t_ia, t_csr = time_ms(lambda: PT @ r, 20), time_ms(scatter, 20), time_ms(lambda: csr @ r, 20)
    plain_ms = time_ms(lambda: gs.sliced_ell_spmm_reference(PT, r), 3)
    del csr
    # each of the d n entries once (value and column, 8 B), x and y once
    b = least_time(nnz * 8 + (r.shape[0] + m2) * 4, 2 * nnz, torch.float32)
    log(f"{name} P^T {PT.shape} float32, {nnz} entries, padding ratio {PT.padding_ratio():.3f}: "
        f"K2 sliced {t_pt:.4f} ms (max|kernel-plain| {err.max().item():.3e} within the bound, "
        f"bitwise stable), the index_add_ it replaces {t_ia:.4f} ms, torch.sparse CSR {t_csr:.4f} ms "
        f"(max|csr-plain| {lib_err:.3e}), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {100 * b['bound_ms'] / t_pt:.0f} %)")
    return dict(max_abs_err=err.max().item(), ms=t_pt, plain_ms=plain_ms, library_ms=t_csr,
                index_add_ms=t_ia, **b)


def aux_p_table(gs, name, aux, r):
    """The aux grid's apply against the plain composition on r (the same
    P^T and V-cycle, then P z as the torch gather K2 replaced) within
    8 eps P|z| + 2 eps |z| (float32: the two P z differ by the kernel's
    fused multiply-adds); K2 on its (d+1..., n) P table against its plain
    version within the per-row bound, the P stage timed against the plain
    gather, a cuSPARSE CSR SpMV of P (timed, never used) and its plain
    version. Returns the measurements."""
    zg = aux.mg.v_cycle(aux.PT @ r)
    idx, w = aux.idx, aux.w
    K, n = idx.shape
    gather = lambda: (zg[idx] * w).sum(dim=0)  # noqa: E731  (P z before K2)
    z_k2, z_plain = aux(r), aux.omega * aux.dinv * r + gather()
    eps32 = torch.finfo(torch.float32).eps
    bound = 8 * eps32 * gs.ell_spmv_reference(w.abs(), idx, zg.abs()) + 2 * eps32 * z_plain.abs()
    apply_err = (z_k2 - z_plain).abs()
    check(bool((apply_err <= bound).all()), f"the {name} apply differs from the plain apply")
    err_p, ratio_p = k2_compact_check(gs, f"the {name}'s P", w, idx, zg)
    plain = lambda: gs.ell_spmv_reference(w, idx, zg)  # noqa: E731
    csr = torch.sparse_csr_tensor(torch.arange(0, idx.numel() + 1, K, device=DEVICE),
                                  idx.T.reshape(-1).long(), w.T.reshape(-1), (n, zg.shape[0]),
                                  check_invariants=False)
    interp = lambda: aux.interpolate(zg)  # noqa: E731
    k1, g1, l1 = time_ms(interp, 20), time_ms(gather, 20), time_ms(lambda: csr @ zg, 20)
    k2, g2, l2 = time_ms(interp, 20), time_ms(gather, 20), time_ms(lambda: csr @ zg, 20)
    plain_ms = time_ms(plain, 5)
    ms = (k1 + k2) / 2
    m2 = zg.shape[0]
    b = least_time(idx.numel() * 8 + (m2 + n) * 4, 2 * idx.numel(), torch.float32)
    lib_err = (csr @ zg - gs.ell_spmv_reference(w, idx, zg)).abs().max().item()
    del csr
    log(f"{name} (grid {aux.n_grid}, m^d = {m2}): apply - plain apply max {apply_err.max().item():.3e}, "
        f"max err/bound (8 eps P|z| + 2 eps |z|) "
        f"{(apply_err / bound.clamp_min(torch.finfo(torch.float32).tiny)).max().item():.3e}; K2 compact "
        f"on P {tuple(w.shape)} f32: max|kernel-plain| {err_p:.3e} (max err/bound {ratio_p:.3e}), bitwise "
        f"stable; the P stage {k1:.4f} / {k2:.4f} ms against the plain gather it replaced "
        f"{g1:.4f} / {g2:.4f} ms, torch.sparse CSR {l1:.4f} / {l2:.4f} ms (max|csr-plain| "
        f"{lib_err:.3e}), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {100 * b['bound_ms'] / ms:.0f} %)")
    return dict(max_abs_err=err_p, ms=ms, plain_ms=plain_ms, library_ms=(l1 + l2) / 2,
                gather_ms=(g1 + g2) / 2, **b)


def phase_general_main_path(ak, gs):
    """MatrixFreeElliptic(gather_kernel="lane") on the scrambled n = 3200
    mesh; returns K2's launch count."""
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic
    from fdapde_core_tpu_torch.ops.dia_split import plan_split_width

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    (x, y, cells, bnd), t_mesh = synced_seconds(lambda: scrambled_mesh(N_MAIN, *SCRAMBLE))
    model, t_build = synced_seconds(lambda: MatrixFreeElliptic(
        (x, y), cells, bnd, K=1.0, gather_kernel="lane", device=DEVICE))
    b = model.load_vector(torch.ones(cells.shape[0], dtype=torch.float64, device=DEVICE))
    (xs, its, rel), t_solve = synced_seconds(lambda: model.solve(b, rtol=1e-8, maxiter=400))
    launches = gs.ell_spmv_launches
    # the same solve again: every sum runs in a fixed order (the aux grid's
    # P^T included), so the iterations and the solution repeat bitwise
    (xs2, its2, _), t_solve2 = synced_seconds(lambda: model.solve(b, rtol=1e-8, maxiter=400))
    log(f"general main path, the solve repeated: {its2} inner iterations in {t_solve2:.4f} s, "
        f"solution bitwise equal: {torch.equal(xs, xs2)}")
    check(its2 == its and torch.equal(xs, xs2), "the repeated lane solve differs from the first")
    aux_pt_table(gs, "aux grid", model.aux)

    log(f"general main path n={N_MAIN} scrambled ({x.shape[0]} dofs, {cells.shape[0]} cells): "
        f"mesh {t_mesh:.4f} s, build (assembly + ELL + aux) {t_build:.4f} s, "
        f"solve {t_solve:.4f} s; {its} inner iterations, true rel residual {rel:.4e}; "
        f"preconditioner {model.preconditioner}, plan {plan_split_width(model.op_ref)}, "
        f"aux grid {model.aux.n_grid}, MG levels {model.aux.mg.shapes}; K2 launches {launches}")
    check(model.preconditioner == "auxgrid+lane", "the band plan accepted the scrambled numbering")
    check(launches > 0, "the general main path never launched the K2 kernel")
    check(xs.dtype == torch.float64 and xs.shape == (x.shape[0],), "solution dtype/shape")
    check(bool(torch.isfinite(xs).all()), "non-finite solution")
    rel_check = true_rel_residual(model.op_ref, bnd, xs, torch.where(bnd, 0.0, b), gs)
    log(f"general main path: recomputed true rel residual {rel_check:.4e}")
    check(rel <= 1e-8 and rel_check <= 1e-8, "lane refined solve did not reach 1e-8")
    check(its == ITERATIONS_KEPT["genscat"], f"lane refined solve took {its} inner iterations, "
                                             f"not {ITERATIONS_KEPT['genscat']}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    TWINS["genscat"] = (xs.cpu(), its)
    return launches


def phase_matfree_poisson(ak, gs):
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device
    from fdapde_core_tpu_torch.models import MatrixFreePoisson

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    nodes, cells, bnd = irregular_mesh_device(N_MAIN, 0.2, dtype=torch.float64, device=DEVICE)
    model, t_build = synced_seconds(lambda: MatrixFreePoisson(
        nodes, cells, bnd, preconditioner="auxgrid", device=DEVICE))
    b = model.load_vector(torch.ones(cells.shape[0], dtype=torch.float64, device=DEVICE))
    (xs, its, rel), t_solve = synced_seconds(lambda: model.solve(b, rtol=1e-9, maxiter=400))
    rel = rel.item()
    rel_check = true_rel_residual(model.op, bnd, xs, torch.where(bnd, 0.0, b), gs)
    log(f"MatrixFreePoisson n={N_MAIN} unscrambled: build {t_build:.4f} s, solve {t_solve:.4f} s; "
        f"{its} iterations, true rel residual {rel:.4e} (recomputed {rel_check:.4e}); "
        f"K2 launches {gs.ell_spmv_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(model.op.vals.dtype == torch.float64, "MatrixFreePoisson ELL is not f64")
    check(gs.ell_spmv_launches > 0, "MatrixFreePoisson never launched K2")
    check(rel <= 1e-9 and rel_check <= 1e-9 and its < 400, "MatrixFreePoisson did not reach 1e-9")


def phase_general_harmonic():
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic

    x, y, cells, bnd = scrambled_mesh(N_HARMONIC, *SCRAMBLE_SMALL)
    model = MatrixFreeElliptic((x, y), cells, bnd, K=1.0, gather_kernel="lane", device=DEVICE)
    g = x + y
    xs, its, rel = model.solve(torch.zeros_like(g), g=g, rtol=1e-11, maxiter=400)
    err = (xs - g).abs().max().item()
    log(f"general harmonic n={N_HARMONIC} scrambled, lane path: max|x - g| = {err:.3e} "
        f"({its} inner iterations, rel {rel:.3e})")
    check(model.preconditioner == "auxgrid+lane", "harmonic model is not on the lane path")
    check(err < 1e-9, "harmonic data not reproduced to 1e-9 on the general path")


def jittered_lattice(nx, seed=7, amp=0.35):
    """The (nx+1)^2 lattice of [0, 1]^2 with interior nodes jittered by
    +-amp h: (nodes (N, 2), boundary (N,) bool), node (i, j) at i (nx+1) + j."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    return pts, ~interior


def delaunay_mesh(nx, seed=7, amp=0.35):
    """bench.py's `general` mesh (bench.py:695-705): the jittered lattice,
    scipy Delaunay. Host NumPy: (nodes (N, 2), cells (C, 3) int32,
    boundary (N,) bool)."""
    from scipy.spatial import Delaunay

    pts, bnd = jittered_lattice(nx, seed, amp)
    return pts, Delaunay(pts).simplices.astype(np.int32), bnd


def street_network(nx, seed=7, amp=0.35):
    """A grid-plan street network: the jittered lattice's nodes joined by
    its horizontal and vertical segments; the square's boundary nodes are
    the network's boundary. (nodes, segments (S, 2) int32, boundary)."""
    pts, bnd = jittered_lattice(nx, seed, amp)
    idx = np.arange((nx + 1) ** 2).reshape(nx + 1, nx + 1)
    segs = np.concatenate([np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
                           np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)])
    return pts, segs.astype(np.int32), bnd


def criss_cross_cells(n):
    """(2 n^2, 3) cells of the n x n criss-cross split on the card, the
    type-A block (a, b, a+1) then the type-B block (b, b+1, a+1), a = node
    (i, j), b = node (i+1, j): the order p1_grid_stencil reads."""
    m = n + 1
    ar = torch.arange(n, device=DEVICE)
    a = (ar[:, None] * m + ar[None, :]).reshape(-1)
    b = a + m
    return torch.cat([torch.stack([a, b, a + 1], 1), torch.stack([b, b + 1, a + 1], 1)])


def phase_local_stiffness(ak, gs, ls, pts, cells):
    """K4, K5 and K6 against their plain versions, timed (K6 on the cells of
    phase 12's mesh); then the structured-stencil path through K4 and K5
    against K1. Returns {name: measurements} with K4's and K5's launches on
    that path."""
    from fdapde_core_tpu_torch.ops.grid_assembly import (
        p1_grid_stencil,
        p1_grid_stencil_offdiag,
        stencil_from_coords,
    )

    def compare(name, kernel, plain, inp, where):
        got, ref = kernel(inp), plain(inp)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 8 * torch.finfo(inp.dtype).eps * ref.abs().max().item()
        stable = torch.equal(got, kernel(inp))
        log(f"{name} {where} {inp.dtype} {tuple(inp.shape)}: max|kernel-plain| = {err:.3e} "
            f"(tol {tol:.3e}), bitwise stable: {stable}")
        check(err <= tol, f"{name} {where} {inp.dtype} disagrees with its plain version")
        check(bool(torch.isfinite(got).all()), f"{name} {where} produced non-finite entries")
        check(stable, f"{name} is not bitwise stable from run to run")
        return err

    def timed(name, kernel, plain, inp, out_rows, where):
        k1, p1 = time_ms(lambda: kernel(inp), 20), time_ms(lambda: plain(inp), 5)
        k2, p2 = time_ms(lambda: kernel(inp), 20), time_ms(lambda: plain(inp), 5)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        cells = inp[0].numel()
        nbytes = cells * (inp.shape[0] + out_rows) * inp.element_size()
        b = least_time(nbytes, cells * OPS_PER_CELL[name], inp.dtype)
        log(f"{name} {where} {inp.dtype}: kernel {k1:.4f} / {k2:.4f} ms "
            f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes / 1e9:.4f} GB computed), "
            f"plain {p1:.4f} / {p2:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=None, **b)

    out = {}
    # K6 at the PDE path's shapes: the (6, C) coordinates of phase 12's mesh
    coords64 = torch.as_tensor(pts[cells].reshape(-1, 6).T.copy(), device=DEVICE)
    for dtype in (torch.float64, torch.float32):
        c = coords64.to(dtype)
        err = compare("K6", ls.p1_stiffness_2d, ls.p1_stiffness_2d_reference, c, f"nx={NX_PDE}")
        if dtype == torch.float64:
            out["K6"] = dict(max_abs_err=err, **timed(
                "K6", ls.p1_stiffness_2d, ls.p1_stiffness_2d_reference, c, 9, f"nx={NX_PDE}"))
    del coords64, c

    # all three on the perturbed n = 3200 criss-cross mesh in f32
    n = N_MAIN
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    X, Y = perturbed_planes(n, torch.float32, gen)
    tri = criss_cross_cells(n)
    xs, ys = X.reshape(-1), Y.reshape(-1)
    coords = torch.stack([v[tri[:, k]] for k in range(3) for v in (xs, ys)])
    edges = torch.stack([coords[2] - coords[0], coords[3] - coords[1],
                         coords[4] - coords[0], coords[5] - coords[1]])
    del tri
    where = f"n={n}"
    compare("K6", ls.p1_stiffness_2d, ls.p1_stiffness_2d_reference, coords, where)
    timed("K6", ls.p1_stiffness_2d, ls.p1_stiffness_2d_reference, coords, 9, where)
    del coords
    for name, kernel, plain, rows in (
        ("K4", ls.p1_stiffness_edges, ls.p1_stiffness_edges_reference, 6),
        ("K5", ls.p1_stiffness_edges_offdiag, ls.p1_stiffness_edges_offdiag_reference, 3),
    ):
        err = compare(name, kernel, plain, edges, where)
        out[name] = dict(max_abs_err=err, **timed(name, kernel, plain, edges, rows, where))
    compare("K4 eps=0.5", lambda e: ls.p1_stiffness_edges(e, 0.5),
            lambda e: ls.p1_stiffness_edges_reference(e, 0.5), edges, where)

    # the structured-stencil path: K4 / K5 local matrices -> grid stencil
    zero_launch_counts(ak, gs)
    G4 = p1_grid_stencil(ls.p1_stiffness_edges(edges), n)
    G5 = p1_grid_stencil_offdiag(ls.p1_stiffness_edges_offdiag(edges), n)
    out["K4"]["launches"] = ls.p1_stiffness_edges_launches
    out["K5"]["launches"] = ls.p1_stiffness_edges_offdiag_launches
    G1 = stencil_from_coords(X, Y, n)
    torch.cuda.synchronize()
    tol = 32 * torch.finfo(torch.float32).eps * G1.data.abs().max().item()
    for name, G in (("p1_grid_stencil(K4)", G4), ("p1_grid_stencil_offdiag(K5)", G5)):
        err = (G.data - G1.data).abs().max().item()
        log(f"{name} n={n} float32 vs K1 stencil_from_coords: max diff {err:.3e} (tol {tol:.3e})")
        check(G.offsets2d == G1.offsets2d and err <= tol, f"{name} disagrees with K1's stencil")
    check(out["K4"]["launches"] > 0 and out["K5"]["launches"] > 0,
          "the structured-stencil path never launched K4 / K5")
    return out


def pde_true_residual(pde, x):
    """The true relative residual of a PDE's masked system (g = 0),
    recomputed on the host in f64, and its rounding floor
    eps || |A~| |x| || / ||b~||."""
    A = pde.stiff().to_scipy()
    free = ~pde.space.boundary_dofs
    xh = x.cpu().numpy()
    b_mod = pde.force().cpu().numpy() * free
    r = b_mod - (free * (A @ (free * xh)) + ~free * xh)
    rel = float(np.linalg.norm(r) / np.linalg.norm(b_mod))
    floor = float(np.finfo(np.float64).eps * np.linalg.norm(
        free * (abs(A) @ (free * abs(xh))) + ~free * abs(xh)) / np.linalg.norm(b_mod))
    return rel, floor


def phase_pde_main_path(ak, gs, ls, pts, cells, bnd, t_mesh):
    """PDE(mesh, -laplacian()).init().solve() at nx = 720 on the mesh
    delaunay_mesh built in t_mesh seconds; returns (pde, K6 launches,
    (solution, solve seconds, iterations))."""
    import fdapde_core_tpu_torch as fdt

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = fdt.Triangulation(pts, cells, bnd)
    t_mesh += time.perf_counter() - t0
    t0 = time.perf_counter()
    pde = fdt.PDE(mesh, -fdt.laplacian(), order=1, device=DEVICE)
    q = pde.quadrature_nodes()
    pde.space.scatter  # the sorted-COO pattern, computed once per space
    t_space = time.perf_counter() - t0
    pde.set_forcing(2 * np.pi ** 2 * np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1]))
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))

    # the fixed-order scatter tables (host, once per space and device),
    # which init() would otherwise build on its first call
    _, t_tables = synced_seconds(lambda: [pde.space.segment_sum(w, pde.device)
                                          for w in ("matrix", "forcing")])
    zero_launch_counts(ak, gs)
    _, t_init = synced_seconds(pde.init)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x, t_solve = synced_seconds(pde.solve)
    k6_launches, k2_launches = ls.p1_stiffness_2d_launches, gs.ell_spmv_launches
    recovered = any("escalating to GMRES" in str(w.message) for w in caught)
    info = pde.solve_info

    rel, floor = pde_true_residual(pde, x)
    c = pde.dof_coords()
    l2 = float(np.sqrt(pde.l2_error(np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]))))
    log(f"PDE main path nx={NX_PDE} ({pde.n_dofs} dofs, {mesh.n_cells} cells, nnz "
        f"{pde.stiff().nnz}): mesh {t_mesh:.4f} s, FEMSpace {t_space:.4f} s, init "
        f"{t_tables + t_init:.4f} s (scatter tables {t_tables:.4f} s + assembly {t_init:.4f} s), "
        f"solve {t_solve:.4f} s; {info.iterations} iterations, converged {info.converged}, "
        f"recovery taken {recovered}, true rel residual (host f64) {rel:.4e} "
        f"(rounding floor {floor:.4e}); "
        f"L2 error {l2:.4e}; K6 launches {k6_launches}, K2 launches {k2_launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(k6_launches >= 1, "the PDE main path never launched the K6 kernel")
    check(bool(torch.isfinite(x).all()) and x.shape == (pde.n_dofs,), "PDE solution shape / finite")
    check(info.converged and not recovered, "the PDE solve did not converge without recovery")
    # CG stops on its recurrence residual (1e-12); the true one drifts from
    # it by about iterations x the rounding floor
    check(rel <= 1e-10, f"true relative residual {rel:.3e} > 1e-10")
    check(l2 < 1e-5, f"L2 error {l2:.3e} >= 1e-5")

    # where the time goes: one warm solve under the profiler
    profiled("warm solve", pde.solve)
    TWINS["general"] = (x.cpu(), info.iterations, pde.force().cpu())
    return pde, k6_launches, (x, t_solve, info.iterations)


def phase_pde_harmonic(pde):
    """Harmonic data through the same PDE and mesh; then entry()'s problem."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.geometry import unit_square_mesh

    c = pde.dof_coords()
    g = c[:, 0] + c[:, 1]
    pde.set_dirichlet_bc(g)
    pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
    pde.init()
    x, t_solve = synced_seconds(pde.solve)
    err = (x - torch.as_tensor(g, device=DEVICE)).abs().max().item()
    log(f"PDE harmonic nx={NX_PDE}: max|x - g| = {err:.3e} ({pde.solve_info.iterations} "
        f"iterations, {t_solve:.4f} s)")
    check(err < 1e-9, "harmonic data not reproduced to 1e-9 through the PDE API")

    small = fdt.PDE(unit_square_mesh(32), -fdt.laplacian(), order=1, device=DEVICE)
    c = small.dof_coords()
    small.set_forcing(np.full(small.quadrature_nodes().shape[0], 4.0))
    small.set_dirichlet_bc(1.0 - c[:, 0] ** 2 - c[:, 1] ** 2)
    small.solve()
    log(f"entry() problem, unit_square_mesh(32): {small.report()}")
    check(small.success, "the entry() problem did not converge")


def phase_k3(ak, gs):
    """K3 against its plain version, timed at n = 3200; then its path
    stencil_from_offdiag_planes(K3) against K1. Returns the measurements
    with K3's launches on that path."""
    from fdapde_core_tpu_torch.ops.grid_assembly import (
        stencil_from_coords,
        stencil_from_offdiag_planes,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)

    def compare(X, Y, n, where):
        got = ak.p1_offdiag_planes_from_coords(X, Y, n)
        ref = ak.p1_offdiag_planes_from_coords_reference(X, Y, n)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 8 * torch.finfo(X.dtype).eps * ref.abs().max().item()
        stable = torch.equal(got, ak.p1_offdiag_planes_from_coords(X, Y, n))
        log(f"K3 n={n} {X.dtype} {where}: max|kernel-plain| = {err:.3e} (tol {tol:.3e}), "
            f"bitwise stable: {stable}")
        check(err <= tol, f"K3 n={n} {X.dtype} disagrees with its plain version")
        check(bool(torch.isfinite(got).all()), "K3 produced non-finite planes")
        check(stable, "K3 is not bitwise stable from run to run")
        return err

    for dtype in (torch.float32, torch.float64):
        W = -(-(N_ODD + 1) // 128) * 128
        compare(*perturbed_planes(N_ODD, dtype, gen, shape=(N_ODD + 8, W)), N_ODD, "junk-padded")
    n, m = N_MAIN, N_MAIN + 1
    X, Y = perturbed_planes(n, torch.float32, gen)
    err = compare(X, Y, n, "(m, m) planes")

    kernel = lambda: ak.p1_offdiag_planes_from_coords(X, Y, n)  # noqa: E731
    plain = lambda: ak.p1_offdiag_planes_from_coords_reference(X, Y, n)  # noqa: E731
    k1, p1 = time_ms(kernel, 50), time_ms(plain, 5)
    k2, p2 = time_ms(kernel, 50), time_ms(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    # reads the X, Y planes over nodes [0, n]^2, writes six (n, n) planes
    nbytes = (2 * m * m + 6 * n * n) * 4
    b = least_time(nbytes, OPS_PER_QUAD_K3 * n * n, torch.float32)
    log(f"K3 n={n} float32: kernel {k1:.4f} / {k2:.4f} ms "
        f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes / 1e9:.4f} GB computed), "
        f"plain {p1:.4f} / {p2:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")

    # its path: planes -> pad-sum stencil conversion, against K1
    zero_launch_counts(ak, gs)
    G3 = stencil_from_offdiag_planes(ak.p1_offdiag_planes_from_coords(X, Y, n), n)
    launches = ak.p1_offdiag_planes_launches
    G1 = stencil_from_coords(X, Y, n)
    torch.cuda.synchronize()
    tol = 32 * torch.finfo(torch.float32).eps * G1.data.abs().max().item()
    diff = (G3.data - G1.data).abs().max().item()
    log(f"stencil_from_offdiag_planes(K3) n={n} float32 vs K1 stencil_from_coords: max diff "
        f"{diff:.3e} (tol {tol:.3e}); K3 launches {launches}")
    check(G3.offsets2d == G1.offsets2d and diff <= tol, "K3's stencil disagrees with K1's")
    check(launches > 0, "the planes path never launched K3")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, launches=launches, **b)


def phase_dia_main_path(ak, gs, ds, ls):
    """assemble_dia -> prune_zero_offsets -> solve_elliptic on
    unit_square_mesh(1024), then the grid multigrid and the harmonic check
    on the same operator. Returns (pruned DIAMatrix, K7 launches)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_dia, assemble_forcing, solve_elliptic
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.geometry import unit_square_mesh
    from fdapde_core_tpu_torch.linear_algebra import prune_zero_offsets
    from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid
    from fdapde_core_tpu_torch.ops.grid_mg import GridMG, mg_preconditioned_cg

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    t0 = time.perf_counter()
    space = FEMSpace(unit_square_mesh(N_DIA), 1)
    space.scatter  # the sorted-COO pattern, computed once per space
    t_space = time.perf_counter() - t0
    q = space.quadrature_nodes
    f = 2 * np.pi ** 2 * np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1])
    D, t_init = synced_seconds(lambda: prune_zero_offsets(
        assemble_dia(space, -fdt.laplacian(), device=DEVICE)))
    b = assemble_forcing(space, f, device=DEVICE)
    mask = torch.as_tensor(space.boundary_dofs, device=DEVICE)
    zero = torch.zeros(space.n_dofs, dtype=torch.float64, device=DEVICE)
    (x, info), t_solve = synced_seconds(lambda: solve_elliptic(D, b, mask, zero, rtol=1e-8,
                                                               maxiter=20000, recovery=False))
    k7, k6 = ds.dia_spmv_launches, ls.p1_stiffness_2d_launches

    # true residual of the masked system through the plain SpMV in f64,
    # beside its rounding floor eps || |A~| |x| || / ||b~||
    sys_ = DirichletSystem(D, mask)
    free = (~mask).to(torch.float64)
    b_mod = sys_.rhs(b, zero)
    Ax = ds.dia_spmv_reference(D.data, D.offsets, x * free) * free + x * mask
    rel = (torch.linalg.norm(b_mod - Ax) / torch.linalg.norm(b_mod)).item()
    absAx = ds.dia_spmv_reference(D.data.abs(), D.offsets, x.abs() * free) * free + x.abs() * mask
    floor = (torch.finfo(torch.float64).eps * torch.linalg.norm(absAx) / torch.linalg.norm(b_mod)).item()
    log(f"DIA path unit_square_mesh({N_DIA}) ({space.n_dofs} dofs, {space.mesh.n_cells} cells): "
        f"offsets {D.offsets} after pruning; FEMSpace {t_space:.4f} s, init (assemble_dia + prune) "
        f"{t_init:.4f} s, solve {t_solve:.4f} s; Jacobi CG {info.iterations} iterations, converged "
        f"{info.converged}, true rel residual (f64) {rel:.4e} (rounding floor {floor:.4e}); "
        f"K7 launches {k7}, K6 launches {k6}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(info.converged and rel <= 1e-8, "the DIA path's Jacobi solve did not reach 1e-8")
    check(k7 >= info.iterations > 0, f"K7 launched {k7} times for {info.iterations} iterations")
    check(k6 >= 1, "assemble_dia never launched K6")
    check(bool(torch.isfinite(x).all()) and x.shape == (space.n_dofs,), "DIA solution shape / finite")

    # the same operator on the grid: Dirichlet fold, V-cycle MG-CG
    m = N_DIA + 1
    G = prune_zero_offsets_grid(GridDIAMatrix.from_dia(D, (m, m)).with_dirichlet_identity(free))
    mg, t_mg = synced_seconds(lambda: GridMG.build(G))
    (xm, relm, km), t_mgcg = synced_seconds(lambda: mg_preconditioned_cg(G, b_mod, rtol=1e-10,
                                                                       maxiter=60, mg=mg))
    dx = (xm - x).abs().max().item() / xm.abs().max().item()
    log(f"DIA path MG-CG (from_dia, levels {mg.shapes}): build {t_mg:.4f} s, solve {t_mgcg:.4f} s, "
        f"{km} iterations, rel residual {relm.item():.4e}; max|x_mg - x_jacobi| / max|x| = {dx:.3e}")
    check(relm.item() <= 1e-10 and km <= 15, f"MG-CG on the DIA operator: {km} iterations")
    check(dx <= 1e-6, "MG-CG and Jacobi solutions of the DIA path disagree")

    # harmonic data through solve_elliptic on the DIA operator
    c = torch.as_tensor(space.dof_coords, device=DEVICE)
    g = c[:, 0] + c[:, 1]
    (xh, infoh), t_h = synced_seconds(lambda: solve_elliptic(
        D, zero, mask, g, rtol=1e-12, maxiter=200, preconditioner=mg.v_cycle))
    err = (xh - g).abs().max().item()
    log(f"DIA path harmonic: max|x - g| = {err:.3e} ({infoh.iterations} iterations, "
        f"V-cycle preconditioner, {t_h:.4f} s)")
    check(infoh.converged and err < 1e-9, "harmonic data not reproduced to 1e-9 on the DIA path")
    TWINS["dia"] = (x.cpu(), info.iterations)
    return D, k7


def flat_stencil_dia(G):
    """The (m, m) grid stencil G as a flat DIAMatrix over m^2 dofs (offset
    di m + dj), after checking that every entry that would wrap across a
    grid row is exactly zero."""
    from fdapde_core_tpu_torch.linear_algebra import DIAMatrix

    m = G.shape2d[1]
    for k, (di, dj) in enumerate(G.offsets2d):
        edge = G.data[k][:, m - 1] if dj > 0 else G.data[k][:, 0] if dj < 0 else None
        check(edge is None or not bool(edge.any()), f"layer {(di, dj)} wraps across a grid row")
    offsets = tuple(di * m + dj for di, dj in G.offsets2d)
    check(offsets == tuple(sorted(offsets)), "flat offsets are not sorted")
    return DIAMatrix(G.data.reshape(len(offsets), -1), offsets, G.n)


def csr_of(S):
    """A torch.sparse CSR tensor of a sorted-COO SparseMatrix (int64 indices)."""
    n = S.shape[0]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=DEVICE)
    crow[1:] = torch.cumsum(torch.bincount(S.rows.long(), minlength=n), 0)
    return torch.sparse_csr_tensor(crow, S.cols.long(), S.vals, S.shape, check_invariants=False)


def phase_k7(ds, operators):
    """K7 against its plain version and a cuSPARSE CSR SpMV on each
    (name, DIAMatrix, reference product or None); returns {name: measurements}."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    out = {}
    for name, D, other in operators:
        K, n = D.data.shape
        dt = D.data.dtype
        x = torch.rand(n, generator=gen, dtype=torch.float64, device=DEVICE).to(dt) - 0.5
        offs = torch.tensor(D.offsets, dtype=torch.int64, device=DEVICE)
        got = ds.dia_spmv(D.data, offs, x)
        ref = ds.dia_spmv_reference(D.data, D.offsets, x)
        bound = K * torch.finfo(dt).eps * ds.dia_spmv_reference(D.data.abs(), D.offsets, x.abs())
        torch.cuda.synchronize()
        err = (got - ref).abs()
        stable = torch.equal(got, ds.dia_spmv(D.data, offs, x))
        log(f"K7 {name} ({K}, {n}) {dt}: max|kernel-plain| = {err.max().item():.3e}, max err/bound = "
            f"{(err / bound.clamp_min(torch.finfo(dt).tiny)).max().item():.3e}, bitwise stable: {stable}")
        check(bool((err <= bound).all()), f"K7 {name} disagrees with its plain version")
        check(bool(torch.isfinite(got).all()), f"K7 {name} produced non-finite values")
        check(stable, f"K7 {name} is not bitwise stable")
        if other is not None:  # the grid stencil's own product on the same x
            diff = ((other(x) - ref).abs() <= bound).all().item()
            log(f"K7 {name}: flat DIA product == grid stencil product within the bound: {diff}")
            check(diff, f"K7 {name}: the flat DIA matrix is not the grid stencil")

        csr, t_csr = synced_seconds(lambda: csr_of(D.to_sparse()))
        lib_err = (csr @ x - ref).abs().max().item()
        kernel = lambda: ds.dia_spmv(D.data, offs, x)  # noqa: E731
        plain = lambda: ds.dia_spmv_reference(D.data, D.offsets, x)  # noqa: E731
        library = lambda: csr @ x  # noqa: E731
        k1, p1, l1 = time_ms(kernel, 50), time_ms(plain, 5), time_ms(library, 50)
        k2, p2, l2 = time_ms(kernel, 50), time_ms(plain, 5), time_ms(library, 50)
        ms, plain_ms, library_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
        nnz = csr.values().numel()
        del csr
        # reads the K diagonals and x, writes y; a multiply-add per entry
        nbytes = (K + 2) * n * D.data.element_size() + 8 * K
        b = least_time(nbytes, 2 * K * n, dt)
        log(f"K7 {name} {dt}: kernel {k1:.4f} / {k2:.4f} ms "
            f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes / 1e9:.4f} GB computed), plain "
            f"{p1:.4f} / {p2:.4f} ms, torch.sparse CSR ({nnz} entries, built from to_sparse() in "
            f"{t_csr:.4f} s) {l1:.4f} / {l2:.4f} ms (max|csr-plain| {lib_err:.3e}); "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        out[name] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, **b)
    return out


def phase_point_location(mesh):
    """DeviceCellLocator against the host CellLocator on N_OBS points;
    returns the inside points (host (n, 2) float64)."""
    from fdapde_core_tpu_torch.geometry import CellLocator, DeviceCellLocator

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    pts = torch.rand((N_OBS, 2), generator=gen, dtype=torch.float64, device=DEVICE) * 1.04 - 0.02
    loc, t_dev_build = synced_seconds(lambda: DeviceCellLocator(mesh, device=DEVICE))
    ids, t_dev = synced_seconds(lambda: loc.locate(pts))
    _, t_dev2 = synced_seconds(lambda: loc.locate(pts))
    pts_h = pts.cpu().numpy()
    host, t_host_build = synced_seconds(lambda: CellLocator(mesh))
    ids_h, t_host = synced_seconds(lambda: host.locate(pts_h))
    ids = ids.cpu().numpy()
    n_diff = int((ids != ids_h).sum())
    log(f"point location, {N_OBS} points on the nx={NX_PDE} mesh ({mesh.n_cells} cells): "
        f"device build {t_dev_build:.4f} s, locate {t_dev:.4f} / {t_dev2:.4f} s; host build "
        f"{t_host_build:.4f} s, locate {t_host:.4f} s; bin table {tuple(loc.table.shape)} "
        f"(K = {loc.capacity}, {loc.table.numel() * 4 / 2**20:.1f} MiB); inside "
        f"{int((ids >= 0).sum())}; ids that differ: {n_diff}")
    check(n_diff == 0, f"device and host point location differ on {n_diff} points")
    return pts_h[ids >= 0]


def today_route(gs, S, X):
    """The route S @ X took before K2's sliced form, built here for the
    comparison: S's (D, n) ELL, every row padded to the longest (value 0,
    column 0), and for a block the ELL of I_c (x) S (c copies of the table,
    copy j reading column j), applied to the (k, n_src) transpose of X.
    Returns (a closure computing S @ X that way, the padding ratio, for a
    vector a closure running the same (D, n) table with its warp widths
    (each 32 rows read the slots their longest row fills), else None)."""
    n, n_src = S.shape
    ptr = torch.searchsorted(S.rows.long(), torch.arange(n + 1, device=DEVICE))
    lens = ptr[1:] - ptr[:-1]
    q = torch.arange(int(lens.max()), device=DEVICE)[:, None]
    live = q < lens[None, :]
    idx = torch.where(live, ptr[:-1][None, :] + q, 0)
    vals = torch.where(live, S.vals.double()[idx], 0.0).contiguous()
    cols = torch.where(live, S.cols[idx], 0).to(torch.int32).contiguous()
    D = vals.shape[0]
    if X.dim() == 1:
        ww = gs.warp_widths(lens)
        return ((lambda: gs.ell_spmv(vals, cols, X)), D * n / S.nnz,
                (lambda: gs.ell_spmv(vals, cols, X, ww)))
    k = X.shape[1]
    c = max(1, min(k, (1 << 24) // max(1, D * n), (2**31 - 1) // max(1, n_src)))
    step = torch.arange(c, dtype=torch.int32, device=DEVICE) * n_src
    tables = {}
    for cj in {min(c, k - j) for j in range(0, k, c)}:
        tables[cj] = (vals.repeat(1, cj).contiguous(),
                      (cols[:, None, :] + step[None, :cj, None]).reshape(D, -1).contiguous())

    def run():
        xt = X.T.contiguous()
        out = []
        for j in range(0, k, c):
            cj = min(c, k - j)
            out.append(gs.ell_spmv(*tables[cj], xt[j:j + cj].reshape(-1)).reshape(cj, n))
        return (out[0] if len(out) == 1 else torch.cat(out)).T

    return run, D * n / S.nnz, None


def k2_table(gs, name, S, k=1, transposed=False, race=True):
    """K2's sliced form on the product S @ X that a path launches, X float64
    random: a vector (k = 1) or an (n_src, k) block, row-major or the
    transposed view of a row-major (k, n_src) block. Checks: the kernel
    against its plain version within the per-row bound width eps sum|a x|;
    bitwise stable; each block column equal to the vector launch on that
    column; equal to today's route (one thread per row either way); with
    ``race``, not slower than today's route (off for tables so small that
    both are one launch's latency); for a vector, that (D, n) table with its
    warp widths equal to it too. Times, by CUDA events, two alternating runs
    after a warm-up: the kernel, today's route (the (D, n) ELL or the I_c
    (x) S copies, built here), for a vector the (D, n) table with its warp
    widths on K2's compact form, a torch.sparse CSR product (cuSPARSE SpMV
    or SpMM, timed, never used) and the plain version; the bound counts each
    stored entry once (12 B), X and Y once. Returns the measurements."""
    A = S.sliced(torch.float64)
    n, n_src = S.shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    rand = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64, device=DEVICE) - 0.5  # noqa: E731
    X = rand(n_src) if k == 1 else rand(k, n_src).T if transposed else rand(n_src, k)
    got = S @ X
    ref = gs.sliced_ell_spmm_reference(A, X)
    bound = A.width * torch.finfo(torch.float64).eps * gs.sliced_ell_spmm_reference(
        A.with_vals(S.vals.double().abs()), X.abs())
    err = (got - ref).abs()
    check(bool((err <= bound).all()), f"K2 on {name} disagrees with its plain version")
    check(bool(torch.isfinite(got).all()), f"K2 on {name} produced non-finite values")
    stable = torch.equal(got, S @ X)
    check(stable, f"K2 on {name} is not bitwise stable")
    columns = "vector"
    if k > 1:
        per_column = torch.stack([gs.sliced_ell_spmm(A, X[:, j]) for j in range(k)], 1)
        columns = f"all {k} block columns == their vector launches: {torch.equal(got, per_column)}"
        check(torch.equal(got, per_column), f"K2 on {name}: a block column differs from its vector launch")
        del per_column
    old, old_padding, compact = today_route(gs, S, X)
    same = torch.equal(got, old())
    check(same, f"K2 on {name} differs from today's route")
    if compact is not None:
        check(torch.equal(compact(), got), f"K2 compact with warp widths on {name} differs")

    csr = csr_of(S.with_vals(S.vals.double()))
    lib_err = (csr @ X - ref).abs().max().item()
    kernel, library = (lambda: S @ X), (lambda: csr @ X)
    n1, o1, l1 = time_ms(kernel, 30), time_ms(old, 30), time_ms(library, 30)
    w1 = None if compact is None else time_ms(compact, 30)
    n2, o2, l2 = time_ms(kernel, 30), time_ms(old, 30), time_ms(library, 30)
    w2 = None if compact is None else time_ms(compact, 30)
    plain_ms = time_ms(lambda: gs.sliced_ell_spmm_reference(A, X), 3)
    ms, old_ms, library_ms = (n1 + n2) / 2, (o1 + o2) / 2, (l1 + l2) / 2
    compact_ms = None if compact is None else (w1 + w2) / 2
    del csr
    check(ms <= old_ms or not race, f"K2 sliced on {name} ({ms:.4f} ms) is slower than today's "
                                    f"route ({old_ms:.4f} ms)")
    nbytes = S.nnz * (8 + 4) + (X.numel() + n * k) * 8
    b = least_time(nbytes, 2 * S.nnz * k, torch.float64)
    layout = "" if k == 1 else f" on X {tuple(X.shape)} {'transposed view' if transposed else 'row-major'}"
    log(f"K2 sliced on {name} {tuple(S.shape)}{layout}: {S.nnz} entries, padding ratio "
        f"{A.padding_ratio():.3f} (width {A.width}; today's {old_padding:.3f}); max|kernel-plain| "
        f"{err.max().item():.3e} within the bound; bitwise stable {stable}; {columns}; == today's "
        f"route {same}; kernel {n1:.4f} / {n2:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of "
        f"{nbytes / 1e9:.4f} GB), today's route {o1:.4f} / {o2:.4f} ms ({old_ms / ms:.2f}x)"
        + ("" if compact is None else f", that table with its warp widths {w1:.4f} / {w2:.4f} ms "
                                      f"({compact_ms / ms:.2f}x)")
        + f", torch.sparse CSR {l1:.4f} / {l2:.4f} ms (max|csr-plain| {lib_err:.3e}), plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
        f"{100 * b['bound_ms'] / ms:.0f} %)")
    return dict(table=f"{name} {tuple(S.shape)}", max_abs_err=err.max().item(), ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, today_ms=old_ms, compact_ms=compact_ms,
                padding=A.padding_ratio(), **b)


def sigma_sweep(gs, name, S):
    """K2's sliced form on S @ x at several sort windows: the padding
    ratio and the time of each, the results equal bitwise."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    x = torch.rand(S.shape[1], generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    out, first = [], None
    for sigma in SIGMAS:
        A = gs.SlicedELL.from_coo(S.rows, S.cols, S.vals.double(), S.shape, sigma=sigma)
        y = A @ x
        first = y if first is None else first
        check(torch.equal(y, first), f"K2 on {name}: the sort window {sigma} changed a sum")
        t1, t2 = time_ms(lambda: A @ x, 30), time_ms(lambda: A @ x, 30)
        out.append(f"sigma {sigma}: padding {A.padding_ratio():.3f}, {t1:.4f} / {t2:.4f} ms")
    log(f"K2 sliced on {name} {tuple(S.shape)} by sort window (results equal): " + "; ".join(out))


def phase_regression(ak, gs, ls, mesh, obs):
    """SmoothingRegression on the phase 17 observations: GCV sweep, fit,
    predict; returns (K2 launches, K6 launches)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem.evaluation import eval_basis_pointwise
    from fdapde_core_tpu_torch.models import SmoothingRegression

    def truth(p):
        return np.sin(2 * np.pi * p[:, 0]) * np.cos(2 * np.pi * p[:, 1])

    rng = np.random.default_rng(SEED + 6)
    y = truth(obs) + SIGMA * rng.standard_normal(obs.shape[0])
    grid = rng.uniform(0.1, 0.9, size=(100_000, 2))
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    model, t_build = synced_seconds(
        lambda: SmoothingRegression(mesh, -fdt.laplacian(), device=DEVICE))
    (best, scores), t_gcv = synced_seconds(
        lambda: model.select_lambda_gcv(obs, y, LAMBDAS, n_probes=N_PROBES))
    c, t_fit = synced_seconds(lambda: model.fit(obs, y, best, rtol=1e-10))
    info = model.solve_info_
    pred, t_pred = synced_seconds(lambda: model.predict(grid))
    k2, k6 = gs.ell_spmv_launches, ls.p1_stiffness_2d_launches
    rmse = float(np.sqrt(((pred.cpu().numpy() - truth(grid)) ** 2).mean()))

    # true relative residual of the normal equations in f64, every product
    # through the plain gather-sum
    Psi, _ = eval_basis_pointwise(model.space, obs, device_locate=True, device=DEVICE)
    yt = torch.as_tensor(y, device=DEVICE)
    rhs = Psi.T.matmul_reference(yt)
    Ac = Psi.T.matmul_reference(Psi.matmul_reference(c)) + best * model.P.matmul_reference(c)
    rel = (torch.linalg.norm(rhs - Ac) / torch.linalg.norm(rhs)).item()
    log(f"regression path, {obs.shape[0]} observations on {model.space.n_dofs} dofs: build "
        f"{t_build:.4f} s, select_lambda_gcv over {LAMBDAS} ({N_PROBES} probes) {t_gcv:.4f} s, "
        f"scores {[f'{v:.6e}' for v in scores]} -> lambda {best}; fit {t_fit:.4f} s, "
        f"{info.iterations} iterations, converged {info.converged}, true rel residual (f64) "
        f"{rel:.4e}; predict at {grid.shape[0]} points {t_pred:.4f} s, RMSE {rmse:.4e} "
        f"(sigma {SIGMA}); K2 launches {k2}, K6 launches {k6}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(best == LAMBDAS[1], f"GCV chose {best}, not the middle lambda {LAMBDAS[1]}")
    check(info.converged and rel <= 1e-8, f"the fit did not converge to 1e-10 (true {rel:.3e})")
    check(bool(torch.isfinite(c).all()) and c.shape == (model.space.n_dofs,), "fit shape / finite")
    check(rmse < SIGMA / 3, f"RMSE {rmse:.4e} >= sigma / 3")
    check(k2 > 0 and k6 >= 1, "the regression path never launched K2 / K6")

    tables = {name: k2_table(gs, name, S) for name, S in (("P", model.P), ("Psi", Psi),
                                                           ("Psi^T", Psi.T))}
    for name, S in (("P", model.P), ("Psi", Psi), ("Psi^T", Psi.T)):
        sigma_sweep(gs, name, S)
        # the Hutchinson block solve's products: 16 probes (gcv's default),
        # the block stored either way
        for transposed in (True, False):
            k2_table(gs, f"{name}, probe block", S, 16, transposed=transposed, race=False)
    profiled("fit", lambda: model.fit(obs, y, best, rtol=1e-10))
    return k2, k6, tables["Psi^T"]


def phase_space_time(ak, gs, ls):
    """SpaceTimeSmoothing on the monitoring design, then the fast
    diagonalization against the Kronecker CG; returns (K2, K6 launches)."""
    from fdapde_core_tpu_torch.fem.evaluation import eval_basis_pointwise
    from fdapde_core_tpu_torch.geometry import Interval, unit_square_mesh
    from fdapde_core_tpu_torch.linear_algebra import cg
    from fdapde_core_tpu_torch.models import (
        ModeDiagPreconditioner,
        SeparableOperator,
        SpaceTimeSmoothing,
        solve_space_time_fdm,
    )

    def truth(p, t):
        return np.sin(np.pi * p[:, 0:1]) * np.sin(np.pi * p[:, 1:2]) * np.exp(-t[None, :])

    rng = np.random.default_rng(SEED + 7)
    locs = rng.uniform(0.05, 0.95, size=(N_SITES, 2))
    times = np.linspace(0.0, 1.0, N_DAYS)
    Y = truth(locs, times) + 0.1 * rng.standard_normal((N_SITES, N_DAYS))
    grid, t_eval = rng.uniform(0.15, 0.85, size=(100, 2)), np.linspace(0.1, 0.9, 7)
    mesh = unit_square_mesh(N_ST_MESH)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    model, t_build = synced_seconds(
        lambda: SpaceTimeSmoothing(mesh, Interval(0.0, 1.0, 24), device=DEVICE))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        C, t_fit = synced_seconds(lambda: model.fit(locs, times, Y, LAM_S, LAM_T, rtol=1e-10))
    escalated = any("escalating" in str(w.message) for w in caught)
    info = model.solve_info_
    pred, t_pred = synced_seconds(lambda: model.predict(grid, t_eval))
    k2, k6 = gs.ell_spmv_launches, ls.p1_stiffness_2d_launches
    rmse = float(np.sqrt(((pred.cpu().numpy() - truth(grid, t_eval)) ** 2).mean()))
    log(f"space-time path, {N_SITES} sites x {N_DAYS} times on {model.space.n_dofs} x "
        f"{model.tspace.n_dofs} dofs: build {t_build:.4f} s, fit {t_fit:.4f} s, "
        f"{info.iterations} iterations, converged {info.converged}, escalation fired {escalated}; "
        f"predict {t_pred:.4f} s, RMSE {rmse:.4e}; K2 launches {k2}, K6 launches {k6}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(info.converged, "the space-time fit did not converge")
    check(bool(torch.isfinite(C).all()) and C.shape == (27, model.space.n_dofs), "coefficients")
    check(rmse < 0.06, f"space-time RMSE {rmse:.4e} >= 0.06")
    check(k2 > 0 and k6 >= 1, "the space-time path never launched K2 / K6")

    # K2 on the tables the fit launched: each term's space factor on the
    # (n_s, n_t) block, its time factor on the (n_t, n_s) block
    n_t, n_s = model.tspace.n_dofs, model.space.n_dofs
    for (T, S), name in zip(model._op.terms, ("Phi^T Phi (x) Psi^T Psi", "lam_t Pt (x) Ms",
                                              "lam_s Mt (x) As")):
        k2_table(gs, f"{name}, space factor", S, n_t, transposed=True)
        k2_table(gs, f"{name}, time factor", T, n_s)

    # fast diagonalization against the Kronecker CG on one two-term pencil;
    # the CG takes the mode-diagonal preconditioner (solve_space_time's
    # escalation), as Jacobi stalls on the time factor's spectrum
    Psi, _ = eval_basis_pointwise(model.space, locs, device_locate=True, device=DEVICE)
    Phi, _ = model.tspace.eval(times, device=DEVICE)
    k2_table(gs, "Phi^T (right-hand side)", Phi.T, N_SITES, transposed=True)
    k2_table(gs, "Psi^T (right-hand side)", Psi.T, n_t)
    Yt = torch.as_tensor(Y, device=DEVICE)
    b = Psi.rmatvec(Phi.rmatvec(Yt.T).T).T.reshape(-1)
    S1, T1 = model.As * LAM_S + model.Ms, model.Pt * LAM_T
    op = SeparableOperator([(T1, model.Ms), (model.Mt, S1)])
    pre = ModeDiagPreconditioner.build(model.Mt.toarray(), T1.toarray(), model.Ms.diagonal(),
                                       S1.diagonal())
    (x_cg, info_cg), t_cg = synced_seconds(
        lambda: cg(op, b, M_inv=pre, rtol=1e-12, maxiter=20000))
    (x_fdm, info_fdm), t_fdm = synced_seconds(
        lambda: solve_space_time_fdm(model.Mt, T1, model.Ms, S1, b, rtol=1e-12, maxiter=20000))
    rel = (torch.linalg.norm(x_fdm - x_cg) / torch.linalg.norm(x_cg)).item()
    log(f"space-time pencil (Mt, lam_t Pt, Ms, lam_s As + Ms): Kronecker CG (mode-diagonal "
        f"preconditioner) {t_cg:.4f} s, "
        f"{info_cg.iterations} iterations, converged {info_cg.converged}; solve_space_time_fdm "
        f"{t_fdm:.4f} s, max {info_fdm.iterations} iterations over 27 modes, converged "
        f"{info_fdm.converged}; ||x_fdm - x_cg|| / ||x_cg|| = {rel:.3e}")
    check(info_cg.converged and info_fdm.converged, "a pencil solve did not converge")
    check(rel <= 1e-8, f"FDM and Kronecker CG differ by {rel:.3e} > 1e-8")
    TWINS["space_time"] = dict(model=model, b=b, C=C.cpu(), its=info.iterations, T1=T1, S1=S1,
                               x_fdm=x_fdm.cpu(), its_fdm=info_fdm.iterations)
    return k2, k6


def heat_exact(x, t):
    """Phase 20's manufactured solution sin(pi x) sin(pi y) e^-t."""
    return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) * np.exp(-t)


def phase_parabolic(ak, gs, ls, mesh):
    """The heat equation through PDE(mesh, dt() - laplacian(), times=...) on
    phase 12's mesh, consistent and lumped mass; returns {path: (K2, K6)}."""
    import fdapde_core_tpu_torch as fdt

    dt = T_HEAT[1] - T_HEAT[0]
    # implicit Euler's local error (dt / 2) u_tt, damped by the slowest
    # mode e^-(2 pi^2 - 1) t, bounds the L2 error by dt / (4 (2 pi^2 - 1))
    # (||sin sin|| = 1/2); the P1 error at h ~ 1/720 is ~1e-6 beside it
    bound = dt / (4 * (2 * np.pi ** 2 - 1)) + 1e-5
    out = {}
    for lumped in (False, True):
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts(ak, gs)
        pde = fdt.PDE(mesh, fdt.dt() - fdt.laplacian(), times=T_HEAT, order=1,
                      lumped_mass=lumped, device=DEVICE)
        c, q = pde.dof_coords(), pde.quadrature_nodes()
        g = heat_exact(c[:, None, :], T_HEAT[None, :])
        pde.set_forcing((2 * np.pi ** 2 - 1) * heat_exact(q[:, None, :], T_HEAT[None, :]))
        pde.set_dirichlet_bc(g)
        pde.set_initial_condition(heat_exact(c, 0.0))
        _, t_init = synced_seconds(pde.init)
        u, t_solve = synced_seconds(pde.solve)
        info = pde.step_info
        k2, k6 = gs.ell_spmv_launches, ls.p1_stiffness_2d_launches
        l2 = float(np.sqrt(pde.l2_error(g)))
        name = "lumped" if lumped else "consistent"
        out[f"heat {name}"] = (k2, k6)
        log(f"20 heat equation, {name} mass, nx={NX_PDE} ({pde.n_dofs} dofs), {T_HEAT.size - 1} "
            f"implicit-Euler steps of dt={dt:g}, rtol 1e-12: init {t_init:.4f} s, solve "
            f"{t_solve:.4f} s; preconditioner {pde.report()['preconditioner']}, CG iterations per "
            f"step {info['iterations'].tolist()}, all "
            f"converged {bool(info['converged'].all())}, GMRES rerun {info['escalated']}; "
            f"max-over-time L2 error {l2:.4e} (held to {bound:.4e}); K2 launches {k2}, K6 launches "
            f"{k6}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        check(u.shape == (pde.n_dofs, T_HEAT.size) and bool(torch.isfinite(u).all()),
              "heat solution shape / finite")
        check(bool(info["converged"].all()) and not info["escalated"] and pde.success,
              f"a {name} heat step needed the GMRES rerun")
        check(l2 < bound, f"heat {name} L2 error {l2:.3e} >= {bound:.3e}")
        check(k2 > 0 and k6 >= 1, "the heat path never launched K2 / K6")
        del pde, u
    return out


class Builds:
    """Times every call of owner.name while active (by default a class's
    static build: AMG's, an aux grid's; or a classmethod, or a module's
    function): [(result, host seconds)]; the exceptions of calls that
    raised in ``failed``."""

    def __init__(self, owner, name="build"):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.raw, self.builds, self.failed = self.owner.__dict__[self.name], [], []
        bound = getattr(self.owner, self.name)

        def timed(*args, **kwargs):
            try:
                obj, t = synced_seconds(lambda: bound(*args, **kwargs))
            except Exception as e:  # recorded in self.failed, then raised on
                self.failed.append(e)
                raise
            self.builds.append((obj, t))
            return obj

        if isinstance(self.raw, classmethod):
            wrapped = classmethod(lambda cls, *args, **kwargs: timed(*args, **kwargs))
        elif isinstance(self.raw, staticmethod):
            wrapped = staticmethod(timed)
        else:
            wrapped = timed
        setattr(self.owner, self.name, wrapped)
        return self.builds

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.raw)


def host_amg_solve(pde, mg):
    """A PDE's AMG solve on the host CPU with the hierarchy mg copied there:
    the same V-cycle and CG code, every product through K2's plain version.
    Returns (x, SolveInfo)."""
    from fdapde_core_tpu_torch.fem.solvers import solve_elliptic
    from fdapde_core_tpu_torch.linear_algebra import AMG, SparseMatrix

    def host(S):
        return SparseMatrix(S.rows.cpu(), S.cols.cpu(), S.vals.cpu(), S.shape)

    mg_h = AMG([host(A) for A in mg.As], [host(P) for P in mg.Ps], [host(R) for R in mg.Rs],
               [d.cpu() for d in mg.dinvs], mg.coarse_inv.cpu(), mg.omega, mg.nu, mg.rhos,
               mg.smoother, mg.cheby_lower)
    mask = torch.as_tensor(pde.space.boundary_dofs)
    b = pde.force().reshape(-1).cpu()
    return solve_elliptic(host(pde.stiff()), b, mask, torch.zeros_like(b), rtol=pde.solver_rtol,
                          maxiter=pde.solver_maxiter, recovery=False, preconditioner=mg_h.v_cycle)


def phase_amg(ak, gs, ls, mesh, aux_run):
    """(a) PDE(..., solver_preconditioner="amg") on phase 12's problem,
    against phase 12's aux-grid solve; K2 on every level's tables; the
    same solve on the host CPU; (b) the "auto" ladder's AMG rung on a
    lifted surface. Returns ({path: (K2, K6)}, (a)'s hierarchy, its
    host set-up seconds, solution and iterations, which phase 31
    restores from a checkpoint)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.linear_algebra.amg import AMG

    x_aux, t_aux, it_aux = aux_run
    out = {}
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    pde = fdt.PDE(mesh, -fdt.laplacian(), order=1, solver_preconditioner="amg", device=DEVICE)
    q = pde.quadrature_nodes()
    pde.set_forcing(2 * np.pi ** 2 * np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1]))
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    _, t_init = synced_seconds(pde.init)
    with Builds(AMG) as builds, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x, t_solve = synced_seconds(pde.solve)
    recovered = any("escalating to GMRES" in str(w.message) for w in caught)
    mg, t_setup = builds[0]
    info = pde.solve_info
    k2, k6 = gs.ell_spmv_launches, ls.p1_stiffness_2d_launches
    out["AMG PDE"] = (k2, k6)
    rel, floor = pde_true_residual(pde, x)
    diff = (x - x_aux).abs().max().item() / x_aux.abs().max().item()
    log(f"21a SA-AMG PDE nx={NX_PDE} ({pde.n_dofs} dofs): init {t_init:.4f} s; AMG host set-up "
        f"{t_setup:.4f} s, levels {mg.level_sizes()}, operator complexity "
        f"{mg.operator_complexity():.4f}; solve {t_solve - t_setup:.4f} s after the set-up, "
        f"{info.iterations} iterations, converged {info.converged}, recovery taken {recovered}, "
        f"true rel residual (host f64) {rel:.4e} (rounding floor {floor:.4e}); the aux-grid solve of "
        f"phase 12: {it_aux} iterations in {t_aux:.4f} s; max|x_amg - x_aux| / max|x_aux| = "
        f"{diff:.3e}; K2 launches {k2}, K6 launches {k6}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(len(builds) == 1, "the AMG PDE built more than one hierarchy")
    check(info.converged and not recovered, "the AMG solve did not converge without recovery")
    check(rel <= 1e-10, f"AMG true relative residual {rel:.3e} > 1e-10")
    check(diff <= 1e-8, f"AMG and aux-grid solutions differ by {diff:.3e} max|x|")
    check(k2 > 0 and k6 >= 1, "the AMG path never launched K2 / K6")

    # K2 on every table the V-cycle launched: each level's A, P and R = P^T
    # (the solve's own sliced tables), against the plain version
    for lvl in range(len(mg.As)):
        for name, S in (("A", mg.As[lvl]), ("P", mg.Ps[lvl]), ("R = P^T", mg.Rs[lvl])):
            k2_table(gs, f"AMG level {lvl} {name}", S, race=False)
    # the same hierarchy and system on the host CPU, every product through
    # K2's plain version: the card's iteration count is the algorithm's
    (x_h, info_h), t_h = synced_seconds(lambda: host_amg_solve(pde, mg))
    diff_h = (x_h - x.cpu()).abs().max().item() / x_aux.abs().max().item()
    log(f"21a the same AMG solve on the host CPU (K2's plain version): {info_h.iterations} "
        f"iterations (card {info.iterations}), converged {info_h.converged}, {t_h:.4f} s; "
        f"max|x_host - x_card| / max|x| = {diff_h:.3e}")
    check(info_h.converged and abs(info_h.iterations - info.iterations) <= 1,
          f"the host AMG solve took {info_h.iterations} iterations, the card {info.iterations}")
    check(diff_h <= 1e-10, f"the host and card AMG solutions differ by {diff_h:.3e} max|x|")
    amg_run = (mg, t_setup, x, info.iterations)
    del pde, builds, x_h

    out.update(phase_surface(ak, gs, ls))
    return out, amg_run


def phase_surface(ak, gs, ls):
    """21b: a surface of >= 20,000 dofs with 3D dof coordinates. The
    default ladder takes the rung the JAX package's takes there, the 3D aux
    grid (SURFACE_JAX_RUNG), and builds no AMG hierarchy; then the same
    surface with solver_preconditioner="amg" keeps the AMG surface path
    driven. Returns {path: (K2, K6)}."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.linear_algebra.amg import AMG
    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner3D

    out = {}
    pts, cells, bnd = delaunay_mesh(NX_SURFACE)
    pts3 = np.column_stack([pts, 0.25 * np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1])])
    for pre in (None, "amg"):
        zero_launch_counts(ak, gs)
        pde = fdt.PDE(fdt.Triangulation(pts3, cells, bnd), -fdt.laplacian(), order=1,
                      solver_preconditioner=pre, device=DEVICE)
        pde.set_forcing(np.ones(pde.quadrature_nodes().shape[0]))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        with Builds(AMG) as amg_builds, Builds(AuxGridPreconditioner3D) as aux_builds:
            x, t_solve = synced_seconds(pde.solve)
        info = pde.solve_info
        k2, k6 = gs.ell_spmv_launches, ls.p1_stiffness_2d_launches
        path = "surface default ladder (3D aux grid)" if pre is None else "AMG surface"
        out[path] = (k2, k6)
        log(f"21b surface z = 0.25 sin(pi x) sin(pi y), nx={NX_SURFACE} ({pde.n_dofs} dofs, "
            f"{pde.domain.n_cells} cells), solver_preconditioner={pre}: AMG hierarchies built "
            f"{len(amg_builds)} (levels {amg_builds[0][0].level_sizes() if amg_builds else None}), 3D aux "
            f"grids built {len(aux_builds)} (grid {aux_builds[0][0].n_grid if aux_builds else None}), "
            f"init + solve {t_solve:.4f} s, {info.iterations} iterations (the JAX package's ladder on "
            f"the CPU: {SURFACE_JAX_RUNG}), converged {info.converged}; K2 launches {k2}, K6 launches "
            f"{k6}")
        check(pde.success and bool(torch.isfinite(x).all()), f"the surface solve ({pre}) did not converge")
        check(k2 > 0, f"the surface path ({pre}) never launched K2")
        if pre is None:
            check(pde.n_dofs >= 20_000 and len(amg_builds) == 0 and len(aux_builds) == 1,
                  "the default ladder on the surface did not take the 3D aux grid, as JAX's does")
            check(abs(info.iterations - SURFACE_JAX_RUNG[1]) <= SURFACE_JAX_RUNG[1] // 10,
                  f"the 3D aux-grid surface solve took {info.iterations} iterations, JAX's "
                  f"{SURFACE_JAX_RUNG[1]}")
        else:
            check(len(amg_builds) == 1 and len(aux_builds) == 0, "the AMG surface solve built no AMG")
    return out


def phase_banded(ak, gs):
    """The banded general path at gen10m size (bench.py:1251-1345) through
    MatrixFreePoisson, the CG rates of the split and the ELL, and
    MatrixFreeElliptic's advection-diffusion at n = 1024 (bench.py:1417-1447).
    Returns ((nodes, cells, bnd), {path: K2 launches})."""
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device, irregular_mesh_device_soa
    from fdapde_core_tpu_torch.linear_algebra import cg, jacobi_preconditioner
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic, MatrixFreePoisson
    from fdapde_core_tpu_torch.ops.dia_split import banded_cg, build_banded_split
    from fdapde_core_tpu_torch.ops.matfree_soa import MatrixFreeSoA

    out = {}
    torch.cuda.reset_peak_memory_stats()
    nodes, cells, bnd = irregular_mesh_device(N_MAIN, 0.2, dtype=torch.float64, device=DEVICE)
    nd = nodes.shape[0]
    zero_launch_counts(ak, gs)
    model, t_build = synced_seconds(lambda: MatrixFreePoisson(nodes, cells, bnd, device=DEVICE))
    S = model.op
    b = model.load_vector(torch.ones(cells.shape[0], dtype=torch.float64, device=DEVICE))
    (x, its, rel), t_solve = synced_seconds(lambda: model.solve(b, rtol=1e-9, maxiter=100))
    out["banded Poisson"] = gs.ell_spmv_launches
    TWINS["gen10m"] = (x.cpu(), its)
    (x2, its2, _), t_solve2 = synced_seconds(lambda: model.solve(b, rtol=1e-9, maxiter=100))
    R, W = S.G.shape2d
    amax = max(abs(a) for a, _ in S.G.offsets2d)
    rem_nnz = 0 if S.rem is None else int((S.rem.vals != 0).sum())
    # the true residual in f64 through the plain product of the assembled ELL
    op, _ = MatrixFreeSoA.build(nodes[:, 0], nodes[:, 1], *cells.T.contiguous(), nd, 8)
    E64, _ = op.to_ell(9)
    del op
    rel_check = true_rel_residual(E64, bnd, x, torch.where(bnd, 0.0, b), gs)
    log(f"22 banded MatrixFreePoisson n={N_MAIN} lattice numbering ({nd} dofs): preconditioner "
        f"{model.preconditioner}, plan (W, amax) = ({W}, {amax}), grid ({R}, {W}), remainder nnz "
        f"{rem_nnz}{' (dropped)' if S.rem is None else ''}, BandedMG levels {model.aux.mg.shapes}; "
        f"build {t_build:.4f} s, solve {t_solve:.4f} s / {t_solve2:.4f} s (again), {its} / {its2} "
        f"iterations, true rel residual {float(rel):.4e} (recomputed in f64 through the plain ELL "
        f"product {rel_check:.4e}), solutions bitwise equal {torch.equal(x, x2)}; K2 launches "
        f"{out['banded Poisson']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(model.preconditioner == "banded_mg", "MatrixFreePoisson did not take the banded split")
    check(float(rel) <= 1e-9 and rel_check <= 1e-9, "the banded solve did not reach 1e-9")
    check(its2 == its and torch.equal(x, x2), "the repeated banded solve differs from the first")
    del model, x, x2

    # Jacobi CG rates: banded_cg on the float32 folded split against CG on
    # the float32 ELL (K2), bytes per iteration as bench.py counts them
    F32 = S.astype(torch.float32).fold_dirichlet(bnd)
    del S
    b32 = torch.where(bnd, 0.0, 1.0).to(torch.float32) / (N_MAIN * N_MAIN)
    banded_cg(F32, b32, 5)
    (_, rn_b, ok), t_b = synced_seconds(lambda: banded_cg(F32, b32, CG_RATE_ITERS))
    dia_bytes = (len(F32.G.offsets2d) + 1) * R * W * 4 + 10 * nd * 4
    del F32
    E32 = E64.astype(torch.float32)
    del E64
    sys_ell = DirichletSystem(E32, bnd)
    jacobi = jacobi_preconditioner(sys_ell.diagonal())
    cg(sys_ell, b32, M_inv=jacobi, rtol=0.0, maxiter=5)
    zero_launch_counts(ak, gs)
    (_, info_e), t_e = synced_seconds(lambda: cg(sys_ell, b32, M_inv=jacobi, rtol=0.0,
                                                 maxiter=CG_RATE_ITERS))
    k2_rate = gs.ell_spmv_launches  # a measurement, not a path: not in the totals
    ell_bytes = (E32.vals.shape[0] * 12 + 10 * 4) * nd
    log(f"22 Jacobi CG rates n={N_MAIN} float32, {CG_RATE_ITERS} iterations: banded_cg "
        f"{CG_RATE_ITERS / t_b:.2f} it/s ({dia_bytes * CG_RATE_ITERS / t_b / 1e9:.1f} GB/s of "
        f"{dia_bytes / 1e9:.3f} GB per iteration, no host sync, breakdown-free {bool(ok)}); Jacobi CG "
        f"on the ELL (K2, one host read per iteration) {CG_RATE_ITERS / t_e:.2f} it/s "
        f"({ell_bytes * CG_RATE_ITERS / t_e / 1e9:.1f} GB/s of {ell_bytes / 1e9:.3f} GB); K2 "
        f"launches {k2_rate}")
    check(bool(ok) and bool(torch.isfinite(rn_b)), "banded_cg broke down")
    check(info_e.iterations == CG_RATE_ITERS and k2_rate > 0, "the ELL CG rate run")
    del E32, sys_ell, b32

    # advection-diffusion-reaction through BiCGStab at n = 1024
    x1, y1, c0, c1, c2, bnd1 = irregular_mesh_device_soa(N_GEN1M, 0.2, dtype=torch.float64,
                                                         device=DEVICE)
    zero_launch_counts(ak, gs)
    adv, t_b1 = synced_seconds(lambda: MatrixFreeElliptic(
        (x1, y1), torch.stack([c0, c1, c2], 1), bnd1, K=(1.3, 0.2, 0.9), b=(1.0, 0.5), c=0.3,
        split_plan=(N_GEN1M + 1, 1), device=DEVICE))
    b1 = adv.load_vector(torch.ones(c0.shape[0], dtype=torch.float64, device=DEVICE))
    (xa, ita, rela), t_a = synced_seconds(lambda: adv.solve(b1, rtol=1e-9, maxiter=200))
    out["banded advection"] = gs.ell_spmv_launches
    log(f"22 banded MatrixFreeElliptic advection-diffusion n={N_GEN1M} ({adv.n_dofs} dofs), "
        f"K=(1.3, 0.2, 0.9), b=(1.0, 0.5), c=0.3: preconditioner {adv.preconditioner}, symmetric "
        f"{adv.is_symmetric}; build {t_b1:.4f} s, BiCGStab {ita} iterations in {t_a:.4f} s, true "
        f"rel residual {float(rela):.4e}; K2 launches {out['banded advection']}")
    check(adv.preconditioner == "banded_mg" and not adv.is_symmetric, "advection model route")
    check(float(rela) <= 1e-9 and ita <= 200 and bool(torch.isfinite(xa).all()),
          "the banded advection solve did not reach 1e-9 within 200 iterations")
    del adv, b1, xa

    # the remainder on the card: split at W + 1, the lattice's diagonal
    # offsets fall outside the stencil window into the ELL remainder, whose
    # product is K2; split @ x must equal the ELL's plain product
    op1, _ = MatrixFreeSoA.build(x1, y1, c0, c1, c2, x1.shape[0], 8)
    E1, _ = op1.to_ell(9)
    del op1
    S1, over = build_banded_split(E1, N_GEN1M + 2, max_rem=4)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    v = torch.rand(E1.shape[1], generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    ref = gs.ell_spmv_reference(E1.vals, E1.cols, v)
    bound = (E1.vals.shape[0] * torch.finfo(torch.float64).eps
             * gs.ell_spmv_reference(E1.vals.abs(), E1.cols, v.abs()))
    zero_launch_counts(ak, gs)
    y = S1 @ v
    out["banded remainder"] = gs.ell_spmv_launches
    rem_nnz = int((S1.rem.vals != 0).sum())
    err = (y - ref).abs()
    log(f"22 banded split at W + 1 = {N_GEN1M + 2} of the n={N_GEN1M} ELL: remainder "
        f"{tuple(S1.rem.vals.shape)}, {rem_nnz} entries, overflow {bool(over)}; "
        f"max|split @ x - ELL @ x (plain)| = {err.max().item():.3e}, within the per-row bound "
        f"{bool((err <= bound).all())}; K2 launches {out['banded remainder']}")
    check(not bool(over) and rem_nnz > 0 and out["banded remainder"] > 0,
          "the split at W + 1 has no remainder on K2")
    check(bool((err <= bound).all()), "split @ x differs from the ELL's product")
    return (nodes, cells, bnd), out


def phase_matfree_parabolic(ak, gs, ls, lattice):
    """MatrixFreeParabolic: (a) the banded route on the n = 3200 lattice mesh,
    chunked == unchunked; (b) the aux-grid route on the scrambled mesh; (c)
    at n = 64 against solve_parabolic(lumped=True). Returns {path: (K2, K6)}."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_matrix, solve_parabolic
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device
    from fdapde_core_tpu_torch.models import MatrixFreeParabolic

    out = {}

    def march(name, nodes, cells, bnd, dt, chunked):
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts(ak, gs)
        model, t_build = synced_seconds(lambda: MatrixFreeParabolic(nodes, cells, bnd, dt,
                                                                    device=DEVICE))
        u0 = torch.sin(np.pi * nodes[:, 0]) * torch.sin(np.pi * nodes[:, 1])
        maxiter = 200
        (u, info), t = synced_seconds(lambda: model.solve(u0, N_STEPS_MF, rtol=1e-9,
                                                          maxiter=maxiter))
        name = f"{name}, dt={dt:g}"
        out[name] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
        same = None
        if chunked:
            uc, infoc = model.solve(u0, N_STEPS_MF, rtol=1e-9, maxiter=maxiter, chunk=5)
            same = torch.equal(uc, u) and infoc["iterations"] == info["iterations"]
        log(f"23 MatrixFreeParabolic {name} ({nodes.shape[0]} dofs), {N_STEPS_MF} "
            f"steps at rtol 1e-9: preconditioner {model.preconditioner}; build {t_build:.4f} s, "
            f"{N_STEPS_MF} steps in {t:.4f} s ({N_STEPS_MF / t:.3f} steps/s); iterations per step "
            f"{info['iterations']} (maxiter {maxiter}), true rel "
            f"residuals {[f'{v:.3e}' for v in info['rel_residuals']]}; chunked == unchunked "
            f"bitwise: {same}; K2 launches {out[name][0]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        check(max(info["rel_residuals"]) <= 1e-9 and bool(torch.isfinite(u).all()),
              f"MatrixFreeParabolic {name} did not reach 1e-9")
        check(same is not False, f"MatrixFreeParabolic {name}: chunked stepping differs")
        return model.preconditioner, u

    nodes, cells, bnd = lattice
    route, _ = march(f"banded, lattice n={N_MAIN}", nodes, cells, bnd, DT_MF, True)
    check(route == "banded_mg", "the lattice mesh did not take the banded route")
    # the aux-grid route on the scrambled relabelling of the same mesh, at
    # a dt where A dominates M / dt: its grid stencil is the unshifted
    # Laplacian (as in JAX), which at dt ~ h^2 over-corrects the smooth
    # modes of A + M / dt. Its trajectory, relabelled, is the banded
    # route's at the same dt
    _, u_lat = march(f"banded, lattice n={N_MAIN}", nodes, cells, bnd, DT_AUX, False)
    del nodes, cells, bnd, lattice
    torch.cuda.empty_cache()
    x, y, cells, bnd = scrambled_mesh(N_MAIN, *SCRAMBLE)
    route, u_scr = march(f"aux grid, scrambled n={N_MAIN}", torch.stack([x, y], 1), cells, bnd,
                         DT_AUX, False)
    diff = (u_scr - u_lat[scramble_perm(x.shape[0], *SCRAMBLE)[1]]).abs().max().item()
    log(f"23 aux-grid route (scrambled) against the banded route (lattice) at dt={DT_AUX:g}: "
        f"max|u_aux - u_banded| / max|u| = {diff / u_lat.abs().max().item():.3e}")
    check(route == "auxgrid", "the scrambled mesh did not take the aux-grid route")
    check(out[f"aux grid, scrambled n={N_MAIN}, dt={DT_AUX:g}"][0] > 0,
          "the aux-grid route never launched K2")
    check(diff <= 1e-7 * u_lat.abs().max().item(), "the aux-grid and banded routes disagree")
    # one aux-grid step at dt ~ h^2, from u0, held to converge within
    # AUX_H2_MAXITER iterations
    del x, y, cells, bnd
    torch.cuda.empty_cache()
    x, y, cells, bnd = scrambled_mesh(N_AUX_H2, *SCRAMBLE)
    nodes_s = torch.stack([x, y], 1)
    name = f"aux grid, scrambled n={N_AUX_H2}, dt={DT_AUX_H2:g}, one step"
    zero_launch_counts(ak, gs)
    model = MatrixFreeParabolic(nodes_s, cells, bnd, DT_AUX_H2, device=DEVICE)
    u0 = torch.sin(np.pi * x) * torch.sin(np.pi * y)
    (_, its, rel), t = synced_seconds(lambda: model.step(u0, rtol=1e-9, maxiter=AUX_H2_MAXITER))
    out[name] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    log(f"23 MatrixFreeParabolic {name}: preconditioner {model.preconditioner}; {int(its)} "
        f"iterations (held to {AUX_H2_MAXITER}) in {t:.4f} s ({1e3 * t / max(int(its), 1):.1f} ms "
        f"an iteration), true rel residual {float(rel):.3e}; K2 launches {out[name][0]}")
    check(model.preconditioner == "auxgrid" and float(rel) <= 1e-9,
          f"the aux-grid step at dt={DT_AUX_H2:g} did not reach 1e-9 in {AUX_H2_MAXITER} iterations")
    del x, y, nodes_s, cells, bnd, u_lat, u_scr, model, u0
    torch.cuda.empty_cache()

    # (c) the banded trajectory is the lumped implicit Euler of the
    # assembled operator
    n, dt, steps = 64, 1e-3, 5
    nodes, cells, bnd = irregular_mesh_device(n, 0.2, dtype=torch.float64, device=DEVICE)
    zero_launch_counts(ak, gs)
    model = MatrixFreeParabolic(nodes, cells, bnd, dt, device=DEVICE)
    u0 = torch.sin(np.pi * nodes[:, 0]) * torch.sin(np.pi * nodes[:, 1])
    u, info = model.solve(u0, steps, rtol=1e-11, maxiter=200, keep_trajectory=True)
    space = FEMSpace(fdt.Triangulation(nodes.cpu().numpy(), cells.cpu().numpy(), bnd.cpu().numpy()), 1)
    A = assemble_matrix(space, -fdt.laplacian(), device=DEVICE)
    M = assemble_matrix(space, fdt.reaction(1.0), device=DEVICE)
    zero = torch.zeros((space.n_dofs, steps + 1), dtype=torch.float64, device=DEVICE)
    us, sinfo = solve_parabolic(A, M, zero, bnd, zero, u0, np.arange(steps + 1) * dt, rtol=1e-11,
                                lumped=True, return_info=True)
    out["parabolic n=64 vs solve_parabolic"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    diff = (info["trajectory"] - us[:, 1:]).abs().max().item()
    log(f"23 MatrixFreeParabolic n={n} ({model.preconditioner}) against solve_parabolic(lumped=True) "
        f"over {steps} steps of dt={dt:g}: max|u_mf - u_host| = {diff:.3e}; iterations "
        f"{info['iterations']} vs {sinfo['iterations'].tolist()}; K2 launches "
        f"{out['parabolic n=64 vs solve_parabolic'][0]}, K6 launches "
        f"{out['parabolic n=64 vs solve_parabolic'][1]}")
    check(model.preconditioner == "banded_mg" and diff <= 1e-10,
          f"MatrixFreeParabolic and solve_parabolic differ by {diff:.3e}")
    return out


def phase_p2(ak, gs, pts, cells, bnd):
    """bench.py's genp2 (bench.py:1452-1524) through the model API: the
    order-2 space of phase 12's mesh, MatrixFreeElliptic.from_space(K=1,
    c=1, max_degree=16) on the aux grid, the solve to 1e-8 twice, the ELL
    against the assembled -Laplace + 1, K2 on the P2 ELL in both forms, and
    the quadratic reproduction at nx = 256. Returns ({path: K2 launches},
    the order-2 space, its scatter tables built, for phase 29, and K2's
    compact form on the P2 ELL)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_matrix
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic
    from fdapde_core_tpu_torch.ops.dia_split import plan_split_width

    out = {}
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    t0 = time.perf_counter()
    space = FEMSpace(fdt.Triangulation(pts, cells, bnd), order=2)
    space.dof_coords
    t_space = time.perf_counter() - t0
    model, t_setup = synced_seconds(lambda: MatrixFreeElliptic.from_space(
        space, K=1.0, c=1.0, max_degree=P2_MAX_DEGREE, device=DEVICE))
    peak_setup = torch.cuda.max_memory_allocated() / 2**30
    E = model.op
    K, n = E.vals.shape
    nnz = ell_nnz(E)
    plan = plan_split_width(E)
    b = model.load_vector(torch.ones(cells.shape[0], dtype=torch.float64, device=DEVICE))
    (x, its, rel), t_solve = synced_seconds(lambda: model.solve(b, rtol=1e-8, maxiter=400, chunk=6))
    out["P2 from_space solve"] = gs.ell_spmv_launches
    (x2, its2, _), t_solve2 = synced_seconds(lambda: model.solve(b, rtol=1e-8, maxiter=400, chunk=6))
    b_mod = torch.where(model.boundary, 0.0, b)
    rel_check = true_rel_residual(E, model.boundary, x, b_mod, gs)
    floor = rounding_floor(gs, E, model.boundary, x, b_mod, its)
    log(f"24 P2 MatrixFreeElliptic.from_space nx={NX_PDE} ({n} dofs, {cells.shape[0]} cells), K=1, "
        f"c=1, max_degree={P2_MAX_DEGREE}: FEMSpace {t_space:.4f} s (host), set-up {t_setup:.4f} s, "
        f"peak device memory {peak_setup:.3f} GiB; ELL ({K}, {n}), {nnz} entries, padding "
        f"{K * n / nnz:.3f} slots read per entry; band plan {plan} -> preconditioner "
        f"{model.preconditioner} over the dof coordinates, aux grid {model.aux.n_grid}; solve "
        f"{t_solve:.4f} s / {t_solve2:.4f} s (again), {its} / {its2} iterations, true rel residual "
        f"{float(rel):.4e} (recomputed in f64 through the plain ELL product {rel_check:.4e}, rounding "
        f"floor iterations x eps || |A| |x| || / ||b|| = {floor:.3e}), solutions bitwise equal "
        f"{torch.equal(x, x2)}; K2 launches {out['P2 from_space solve']}")
    check(n == P2_DOFS and model.order == 2, f"P2 space has {n} dofs, not {P2_DOFS}")
    check(model.preconditioner == "auxgrid", "the P2 model did not take the aux grid")
    check(float(rel) <= 1e-8 and rel_check <= 1e-8 + floor and bool(torch.isfinite(x).all()),
          "the P2 solve did not reach 1e-8")
    check(its2 == its and torch.equal(x, x2), "the repeated P2 solve differs from the first")
    check(its == ITERATIONS_KEPT["P2"], f"the P2 solve took {its} iterations, not "
                                        f"{ITERATIONS_KEPT['P2']}")
    check(out["P2 from_space solve"] > 0, "the P2 path never launched K2")
    del x, x2

    # the independent witness: the port's assembled P2 matrix of -Laplace + 1
    t0 = time.perf_counter()
    space.scatter
    _ = space.segment_sum("matrix", DEVICE)
    t_tables = time.perf_counter() - t0
    A, t_asm = synced_seconds(lambda: assemble_matrix(space, -fdt.laplacian() + fdt.reaction(1.0),
                                                      device=DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    v = torch.rand(n, generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    ya, ye = A @ v, E @ v
    wit = ((ye - ya).abs().max() / ya.abs().max()).item()
    log(f"24 P2 ELL @ v against the assembled P2 matrix of -Laplace + 1 (assemble_matrix on the card: "
        f"host scatter tables {t_tables:.4f} s, assembly {t_asm:.4f} s, nnz {A.nnz}): max|ELL v - A v| "
        f"/ max|A v| = {wit:.3e}")
    check(A.nnz == nnz, f"the P2 ELL holds {nnz} entries, the assembled matrix {A.nnz}")
    check(wit <= 1e-12, "the P2 ELL differs from the assembled matrix")

    # K2 on the P2 ELL: the model's compact (49, n) table with its warp
    # widths, beside the same matrix in the sliced form (k2_table, whose
    # "today's route" is the compact table padded to the longest row)
    table = k2_ell_table(gs, "24 the P2 ELL", E, v)
    k2_table(gs, "the assembled P2 matrix", A, race=False)
    del A, E, model, v, ya, ye
    torch.cuda.empty_cache()

    # P2 reproduces u = x^2 + y^2: f = -4 per cell, g = u at the dofs
    pq, cq, bq = delaunay_mesh(N_P2_QUADRATIC)
    sq = FEMSpace(fdt.Triangulation(pq, cq, bq), order=2)
    zero_launch_counts(ak, gs)
    mq = MatrixFreeElliptic.from_space(sq, K=1.0, max_degree=P2_MAX_DEGREE, device=DEVICE)
    u = torch.as_tensor((sq.dof_coords ** 2).sum(1), device=DEVICE)
    f = torch.full((cq.shape[0],), -4.0, dtype=torch.float64, device=DEVICE)
    xq, itq, relq = mq.solve(mq.load_vector(f), g=u, rtol=1e-10, maxiter=400)
    out["P2 quadratic"] = gs.ell_spmv_launches
    errq = ((xq - u).abs().max() / u.abs().max()).item()
    log(f"24 P2 quadratic u = x^2 + y^2 on delaunay_mesh({N_P2_QUADRATIC}) ({sq.n_dofs} dofs): "
        f"max|x - u| / max|u| = {errq:.3e} ({itq} iterations, rel {float(relq):.3e}, "
        f"{mq.preconditioner}); K2 launches {out['P2 quadratic']}")
    check(errq <= 1e-8, "P2 does not reproduce x^2 + y^2 to 1e-8")
    return out, space, table


def phase_lane_aux(ak, gs):
    """bench.py's gendel (bench.py:1528-1742) through the model API: a
    Delaunay base red-refined on the card, strip-renumbered, then
    MatrixFreeElliptic(gather_kernel="lane", aux_kernel="lane") with its
    LaneAuxGrid: the apply against the plain one, K2 on P and on the P1
    ELL (f32 and f64), the refined solve to 1e-8 twice. Returns ({path: K2
    launches}, K2's compact form on the P1 ELL by dtype)."""
    from fdapde_core_tpu_torch.geometry import strip_order_binned, uniform_refine_device
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic
    from fdapde_core_tpu_torch.ops.dia_split import plan_split_width
    from fdapde_core_tpu_torch.ops.lane_aux import LaneAuxGrid, lane_friendly_grid_n

    out = {}
    torch.cuda.reset_peak_memory_stats()
    (pts, cells0, bnd0), t_base = synced_seconds(lambda: delaunay_mesh(NX_GENDEL, seed=GENDEL_SEED))
    base = [torch.as_tensor(np.ascontiguousarray(a), device=DEVICE)
            for a in (pts[:, 0], pts[:, 1], *cells0.T, bnd0)]
    zero_launch_counts(ak, gs)
    (x, y, c0, c1, c2, bnd), t_refine = synced_seconds(
        lambda: uniform_refine_device(*base, GENDEL_LEVELS))  # raises on a failed Euler witness
    n, C, n0 = x.shape[0], c0.shape[0], pts.shape[0]
    area = 0.5 * ((x[c1] - x[c0]) * (y[c2] - y[c0]) - (y[c1] - y[c0]) * (x[c2] - x[c0])).abs()
    area_err = abs(area.sum().item() - 1.0)
    deg = torch.bincount(torch.cat([c0, c1, c2]).long(), minlength=n)
    deg0 = torch.as_tensor(np.bincount(cells0.ravel(), minlength=n0), device=DEVICE)
    new_deg = torch.where(bnd[n0:], 3, 6)  # an edge midpoint: 6 cells, 3 on the boundary
    hist0, hist = torch.bincount(deg0).tolist(), torch.bincount(deg).tolist()
    degrees_kept = torch.equal(deg[:n0], deg0) and torch.equal(deg[n0:], new_deg)
    (order, rank), t_order = synced_seconds(lambda: strip_order_binned(x, y, GENDEL_POP))
    x, y, bnd = x[order], y[order], bnd[order]
    cells = torch.stack([rank[c0], rank[c1], rank[c2]], 1)
    del c0, c1, c2, area, deg, order, rank
    log(f"25 gendel base: {n0} nodes, {cells0.shape[0]} cells (host Delaunay {t_base:.4f} s), degree "
        f"histogram {dict((d, c) for d, c in enumerate(hist0) if c)}; refined {GENDEL_LEVELS} times on "
        f"the card in {t_refine:.4f} s: {n} nodes, {C} cells, {int(bnd.sum())} boundary nodes, "
        f"sum of cell areas - 1 = {area_err:.3e}, degree histogram "
        f"{dict((d, c) for d, c in enumerate(hist) if c)} (the base's plus 6 for the new interior nodes, "
        f"3 on the boundary: {degrees_kept}); strip_order_binned(pop={GENDEL_POP}) {t_order:.4f} s")
    check((n, C, int(bnd.sum())) == GENDEL_SIZES, f"refined sizes {(n, C, int(bnd.sum()))}")
    check(area_err <= 1e-12, "the refined cells do not tile the unit square")
    check(degrees_kept, "refinement changed a base degree or gave a new node other than 6 (3) cells")
    model, t_build = synced_seconds(lambda: MatrixFreeElliptic(
        (x, y), cells, bnd, max_degree=12, gather_kernel="lane", aux_kernel="lane",
        preconditioner="auxgrid", device=DEVICE))
    peak_build = torch.cuda.max_memory_allocated() / 2**30
    la = model.aux
    E = model.op_ref
    bw = int((E.cols.long() - torch.arange(n, device=DEVICE)[None, :]).abs().max())
    plan = plan_split_width(E.astype(torch.float32), bcap=16384)
    check(model.preconditioner == "auxgrid+lane" and isinstance(la, LaneAuxGrid),
          "the gendel model is not on the lane aux grid")
    check(la.n_grid == lane_friendly_grid_n(n), f"aux grid {la.n_grid} != lane_friendly_grid_n")

    # the LaneAuxGrid apply against the plain composition on the same r,
    # and K2 on its P
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    r = torch.rand(n, generator=gen, dtype=torch.float32, device=DEVICE) - 0.5
    aux_p_table(gs, "25 LaneAuxGrid", la, r)

    # K2 on the grown mesh's P1 ELL: the f32 table of the inner CG and the
    # f64 one of the outer residuals
    tables = {}
    for Ek in (model.op, E):
        v = torch.rand(n, generator=gen, dtype=Ek.vals.dtype, device=DEVICE) - 0.5
        tables[str(Ek.vals.dtype).removeprefix("torch.")] = k2_ell_table(
            gs, "25 the grown mesh's P1 ELL", Ek, v)
        del v

    rhs = torch.where(bnd, 0.0, 1.0).to(torch.float64) / n
    zero_launch_counts(ak, gs)
    (xs, its, rel), t_solve = synced_seconds(lambda: model.solve(rhs, rtol=1e-8, maxiter=400, chunk=16))
    out["lane aux solve"] = gs.ell_spmv_launches
    (xs2, its2, _), t_solve2 = synced_seconds(lambda: model.solve(rhs, rtol=1e-8, maxiter=400, chunk=16))
    rel_check = true_rel_residual(E, bnd, xs, torch.where(bnd, 0.0, rhs), gs)
    log(f"25 gendel MatrixFreeElliptic lane + lane aux ({n} dofs): build {t_build:.4f} s (peak device "
        f"memory {peak_build:.3f} GiB), ELL {tuple(E.vals.shape)}, bandwidth {bw}, "
        f"plan_split_width(bcap=16384) {plan}; solve {t_solve:.4f} s / {t_solve2:.4f} s (again), "
        f"{its} / {its2} inner iterations, true rel residual {rel:.4e} (recomputed in f64 through "
        f"the plain ELL product {rel_check:.4e}), solutions bitwise equal {torch.equal(xs, xs2)}; "
        f"K2 launches {out['lane aux solve']}")
    check(rel <= 1e-8 and rel_check <= 1e-8 and bool(torch.isfinite(xs).all()),
          "the gendel lane solve did not reach 1e-8")
    check(its2 == its and torch.equal(xs, xs2), "the repeated gendel solve differs from the first")
    check(its == ITERATIONS_KEPT["gendel"], f"the gendel solve took {its} inner iterations, not "
                                            f"{ITERATIONS_KEPT['gendel']}")
    check(out["lane aux solve"] > 0, "the gendel path never launched K2")
    return out, tables


def rounding_floor(gs, E, bnd, x, b_mod, its):
    """iterations x eps || |A~| |x| || / ||b~||: how far a CG's recurrence
    residual may drift from its true one in f64."""
    free = (~bnd).to(torch.float64)
    return its * torch.finfo(torch.float64).eps * (torch.linalg.norm(
        gs.ell_spmv_reference(E.vals.double().abs(), E.cols, x.abs() * free) * free
        + x.abs() * (1 - free)) / torch.linalg.norm(b_mod)).item()


def k2_ell_table(gs, name, E, v):
    """K2's compact form on a square (K, n) ELL E at v with E's warp
    widths: against its plain version within the per-row bound, bitwise
    stable, equal to the launch without the widths; timed with and without
    them against a cuSPARSE CSR SpMV of its stored entries (timed, never
    used) and its plain version, with its bounds on the entries stored and
    on the slots it reads. Returns the measurements."""
    V, C, W = E.vals, E.cols, E.warp_w
    check(W is not None, f"the {name} ELL came without its warp widths")
    Kp, n = V.shape
    nnz = ell_nnz(E)
    vb, xb = V.element_size(), v.element_size()
    err, ratio = k2_compact_check(gs, name, V, C, v, W)
    csr = ell_csr(V, C)
    lib_err = (csr @ v - gs.ell_spmv_reference(V, C, v)).abs().max().item()
    kernel, full, library = (lambda: gs.ell_spmv(V, C, v, W)), (lambda: gs.ell_spmv(V, C, v)), \
        (lambda: csr @ v)
    ka, fa, ca = time_ms(kernel, 20), time_ms(full, 20), time_ms(library, 20)
    kb, fb, cb = time_ms(kernel, 20), time_ms(full, 20), time_ms(library, 20)
    p_ms = time_ms(lambda: gs.ell_spmv_reference(V, C, v), 3)
    del csr
    ms = (ka + kb) / 2
    read = slots_read(gs, W, n)
    b_nnz = least_time(nnz * (vb + 4) + 2 * n * xb, 2 * nnz, V.dtype)
    b_read = least_time(read * (vb + 4) + 2 * n * xb, 2 * read, V.dtype)
    log(f"K2 compact on {name} ({Kp}, {n}) {V.dtype}: max|kernel-plain| {err:.3e} "
        f"(max err/bound {ratio:.3e}), bitwise stable, == the launch without warp widths; kernel "
        f"with warp widths {ka:.4f} / {kb:.4f} ms, without {fa:.4f} / {fb:.4f} ms, torch.sparse "
        f"CSR {ca:.4f} / {cb:.4f} ms (max|csr-plain| {lib_err:.3e}), plain {p_ms:.4f} ms; slots "
        f"read per entry {read / nnz:.3f} with the widths, {Kp * n / nnz:.3f} without; bound on "
        f"its {nnz} entries {b_nnz['bound_ms']:.4f} ms ({b_nnz['bound_by']}, "
        f"{100 * b_nnz['bound_ms'] / ms:.0f} %), on the {read} slots it reads "
        f"{b_read['bound_ms']:.4f} ms ({100 * b_read['bound_ms'] / ms:.0f} %)")
    return dict(max_abs_err=err, ms=ms, full_ms=(fa + fb) / 2, plain_ms=p_ms,
                library_ms=(ca + cb) / 2, slots_per_entry=read / nnz,
                full_slots_per_entry=Kp * n / nnz, **b_nnz)


def phase_gen3d(ak, gs):
    """bench.py's gen3d (bench.py:1988-2142) through the model API: the
    n = 128 jittered Freudenthal cube, MatrixFreePoisson "auto" on its
    banded split with BandedMGPreconditioner3D, the solve to 1e-9 twice,
    the Jacobi CG rates of the split and of the ELL on K2, K2 on the
    (16, n) 3D ELL in f64 and f32, and harmonic reproduction. Returns
    ((x, y, z, cells, bnd), {path: K2 launches})."""
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.geometry import cube_mesh_device, cube_mesh_device_soa
    from fdapde_core_tpu_torch.linear_algebra import cg, jacobi_preconditioner
    from fdapde_core_tpu_torch.models import MatrixFreePoisson
    from fdapde_core_tpu_torch.ops.dia_split3d import BandedMGPreconditioner3D
    from fdapde_core_tpu_torch.ops.matfree_soa import MatrixFreeSoA3D

    out = {}
    n = N_GEN3D
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ak, gs)
    parts, t_mesh = synced_seconds(lambda: cube_mesh_device_soa(n, 0.2, dtype=torch.float64,
                                                                device=DEVICE))
    x, y, z, c0, c1, c2, c3, bnd = parts
    nodes, cells = torch.stack([x, y, z], 1), torch.stack([c0, c1, c2, c3], 1)
    stacked = cube_mesh_device(n, 0.2, dtype=torch.float64, device=DEVICE)
    same = (torch.equal(stacked[0], nodes) and torch.equal(stacked[1], cells)
            and torch.equal(stacked[2], bnd))
    del stacked
    nd, C = x.shape[0], c0.shape[0]
    log(f"26 gen3d mesh n={n}: {nd} nodes, {C} tets, {int(bnd.sum())} boundary nodes, on the card in "
        f"{t_mesh:.4f} s; cube_mesh_device's arrays equal: {same}")
    check((nd, C) == GEN3D_SIZES, f"gen3d sizes {(nd, C)}")
    check(same, "cube_mesh_device differs from cube_mesh_device_soa")

    model, t_build = synced_seconds(lambda: MatrixFreePoisson(nodes, cells, bnd, device=DEVICE))
    peak_build = torch.cuda.max_memory_allocated() / 2**30
    S = model.op
    R, M, W1 = S.G.shape3d
    rem_nnz = 0 if S.rem is None else int((S.rem.vals != 0).sum())
    bmg, t_bmg = synced_seconds(lambda: BandedMGPreconditioner3D.build(
        S.astype(torch.float32).fold_dirichlet(bnd)))
    log(f"26 MatrixFreePoisson (auto): preconditioner {model.preconditioner}, (W1, W2) = ({W1}, "
        f"{M * W1}), lattice {S.G.shape3d}, {len(S.G.offsets3d)} offsets, remainder nnz {rem_nnz}"
        f"{' (dropped)' if S.rem is None else ''}; build {t_build:.4f} s (peak device memory "
        f"{peak_build:.3f} GiB); BandedMGPreconditioner3D set-up alone {t_bmg:.4f} s, levels "
        f"{bmg.mg.shapes}")
    check(model.preconditioner == "banded_mg" and (W1, M * W1) == (n + 1, (n + 1) ** 2),
          f"gen3d route {model.preconditioner} with (W1, W2) = ({W1}, {M * W1})")
    check(bmg.mg.shapes == model.aux.mg.shapes, "the BandedMG levels differ between builds")
    del bmg

    rhs = torch.where(bnd, 0.0, 1.0).to(torch.float64) / C
    zero_launch_counts(ak, gs)
    (xs, its, rel), t_solve = synced_seconds(lambda: model.solve(rhs, rtol=1e-9, maxiter=100))
    out["gen3d banded Poisson"] = gs.ell_spmv_launches
    (xs2, its2, _), t_solve2 = synced_seconds(lambda: model.solve(rhs, rtol=1e-9, maxiter=100))

    # the assembled (16, n) ELL: the exact-split witness, the true residual
    # and K2's tables
    op, _ = MatrixFreeSoA3D.build(x, y, z, c0, c1, c2, c3, nd, 24)
    (E64, overc), t_ell = synced_seconds(lambda: op.to_ell(16))
    del op
    peak_ell = torch.cuda.max_memory_allocated() / 2**30
    check(not bool(overc), "the 3D ELL exceeds 16 columns")
    b_mod = torch.where(bnd, 0.0, rhs)
    rel_check = true_rel_residual(E64, bnd, xs, b_mod, gs)
    floor = rounding_floor(gs, E64, bnd, xs, b_mod, its)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    v = torch.rand(nd, generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    ref = gs.ell_spmv_reference(E64.vals, E64.cols, v)
    bound = 16 * torch.finfo(torch.float64).eps * gs.ell_spmv_reference(E64.vals.abs(), E64.cols,
                                                                         v.abs())
    split_err = (S @ v - ref).abs()
    log(f"26 banded solve rtol 1e-9: {t_solve:.4f} s / {t_solve2:.4f} s (again), {its} / {its2} "
        f"iterations, true rel residual {float(rel):.4e} (recomputed in f64 through the plain ELL "
        f"product {rel_check:.4e}, rounding floor {floor:.3e}), solutions bitwise equal "
        f"{torch.equal(xs, xs2)}; K2 launches {out['gen3d banded Poisson']}; the (16, {nd}) ELL built "
        f"in {t_ell:.4f} s (peak device memory {peak_ell:.3f} GiB); max|split @ v - ELL @ v (plain)| "
        f"{split_err.max().item():.3e}, within the per-row bound {bool((split_err <= bound).all())}")
    check(float(rel) <= 1e-9 and rel_check <= 1e-9 + floor and bool(torch.isfinite(xs).all()),
          "the gen3d banded solve did not reach 1e-9")
    check(its2 == its and torch.equal(xs, xs2), "the repeated gen3d solve differs from the first")
    check(its == ITERATIONS_KEPT["gen3d"], f"the gen3d solve took {its} iterations, not "
                                           f"{ITERATIONS_KEPT['gen3d']}")
    check(bool((split_err <= bound).all()), "the 3D split differs from the ELL")
    del xs, xs2, v, ref, bound, split_err

    # Jacobi CG rates (bench.py's gen3d_dia_cg_iters_per_s): the float32
    # folded split against the float32 ELL on K2
    F32 = S.astype(torch.float32).fold_dirichlet(bnd)
    F32 = F32 if rem_nnz else F32.drop_empty_remainder()
    E32 = E64.astype(torch.float32)
    rhs32 = rhs.to(torch.float32)
    rates = {}
    for name, A in (("folded split", F32), ("ELL (K2)", E32)):
        sysd = DirichletSystem(A, bnd)
        jac = jacobi_preconditioner(sysd.diagonal())
        cg(sysd, rhs32, M_inv=jac, rtol=0.0, maxiter=3)
        (_, info_r), t_r = synced_seconds(lambda: cg(sysd, rhs32, M_inv=jac, rtol=0.0,
                                                     maxiter=2 * GEN3D_ITERS))
        rates[name] = 2 * GEN3D_ITERS / t_r
        check(info_r.iterations == 2 * GEN3D_ITERS, f"the {name} CG rate run")
    L = len(F32.G.offsets3d)
    RW = R * M * W1
    log(f"26 Jacobi CG rates float32, {2 * GEN3D_ITERS} iterations (one host read each): folded "
        f"split {rates['folded split']:.2f} it/s ({((L + 1) * RW * 4 + 10 * nd * 4) * rates['folded split'] / 1e9:.1f} "
        f"GB/s as bench.py counts), ELL on K2 {rates['ELL (K2)']:.2f} it/s "
        f"({(16 * 8 + 10 * 4) * nd * rates['ELL (K2)'] / 1e9:.1f} GB/s)")
    del F32, sysd

    # K2 on the (16, n) 3D ELL, f64 (the outer residuals) and f32
    tables = {}
    for Ek in (E64, E32):
        v = torch.rand(nd, generator=gen, dtype=Ek.vals.dtype, device=DEVICE) - 0.5
        tables[str(Ek.vals.dtype)] = k2_ell_table(gs, "26 the 3D ELL", Ek, v)
    del E32, v

    # harmonic u = x + 2y - z reproduced through the boundary data
    u = x + 2 * y - z
    zero_launch_counts(ak, gs)
    # at n = 128 the error is ~200x the relative residual (1.1e-9 at 5e-12)
    (xh, ith, relh), t_h = synced_seconds(lambda: model.solve(torch.zeros_like(u), g=u, rtol=1e-13,
                                                              maxiter=60))
    out["gen3d harmonic"] = gs.ell_spmv_launches
    errh = ((xh - u).abs().max() / u.abs().max()).item()
    log(f"26 harmonic u = x + 2y - z: max|x - u| / max|u| = {errh:.3e} ({ith} iterations in "
        f"{t_h:.4f} s, rel {float(relh):.3e}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(errh <= 1e-9, "gen3d does not reproduce x + 2y - z to 1e-9")
    del model, S, E64, xh, u
    return (x, y, z, cells, bnd), out, tables


def phase_aux3d(ak, gs, mesh):
    """The 3D aux-grid route and the rest of 3D: MatrixFreeElliptic(K=1,
    gather_kernel="lane") on a block-scrambled relabelling of phase 26's
    mesh ("auxgrid+lane" over an AuxGridPreconditioner3D), its apply and
    K2 on its P and P^T, the solve to 1e-8 twice, equal to the lattice
    numbering's solution; MatrixFreeParabolic at n = 64 on both routes;
    PDE(unit_cube_mesh(32)) through the default ladder. Returns {path:
    K2 launches} and the P / P^T measurements."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.geometry import cube_mesh_device, unit_cube_mesh
    from fdapde_core_tpu_torch.linear_algebra.amg import AMG
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic, MatrixFreeParabolic
    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner3D
    from fdapde_core_tpu_torch.ops.dia_split3d import plan_split_3d

    out = {}
    x, y, z, cells, bnd = mesh
    nd, C = x.shape[0], cells.shape[0]
    torch.cuda.reset_peak_memory_stats()
    p, pinv = scramble_perm(nd, *SCRAMBLE)
    coords_s = (x[pinv], y[pinv], z[pinv])
    cells_s, bnd_s = p[cells.long()].to(torch.int32), bnd[pinv]
    zero_launch_counts(ak, gs)
    model, t_build = synced_seconds(lambda: MatrixFreeElliptic(
        coords_s, cells_s, bnd_s, K=1.0, gather_kernel="lane", preconditioner="auto", device=DEVICE))
    peak_build = torch.cuda.max_memory_allocated() / 2**30
    aux = model.aux
    E = model.op_ref
    plan = plan_split_3d(E)
    log(f"27 MatrixFreeElliptic K=1, gather_kernel='lane', 'auto' on the block-scrambled relabelling "
        f"{SCRAMBLE} of phase 26's mesh ({nd} dofs): preconditioner {model.preconditioner}, "
        f"plan_split_3d {plan}, {type(aux).__name__} over {aux.n_grid}^3 cells (MG levels "
        f"{aux.mg.shapes}), ELL {tuple(E.vals.shape)}; build {t_build:.4f} s (peak device memory "
        f"{peak_build:.3f} GiB)")
    check(model.preconditioner == "auxgrid+lane" and isinstance(aux, AuxGridPreconditioner3D)
          and aux.n_grid == N_GEN3D and plan == (None, None), "the scrambled cube's route")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    r = torch.rand(nd, generator=gen, dtype=torch.float32, device=DEVICE) - 0.5
    tables = {"P": aux_p_table(gs, "27 the 3D aux grid", aux, r),
              "P^T": aux_pt_table(gs, "27 the 3D aux grid", aux)}
    del r

    b = model.load_vector(torch.ones(C, dtype=torch.float64, device=DEVICE))
    zero_launch_counts(ak, gs)
    (xs, its, rel), t_solve = synced_seconds(lambda: model.solve(b, rtol=1e-8, maxiter=400))
    out["3D aux grid lane solve"] = gs.ell_spmv_launches
    (xs2, its2, _), t_solve2 = synced_seconds(lambda: model.solve(b, rtol=1e-8, maxiter=400))
    b_mod = torch.where(bnd_s, 0.0, b)
    rel_check = true_rel_residual(E, bnd_s, xs, b_mod, gs)
    floor = rounding_floor(gs, E, bnd_s, xs, b_mod, its)
    log(f"27 lane solve rtol 1e-8: {t_solve:.4f} s / {t_solve2:.4f} s (again), {its} / {its2} inner "
        f"iterations, true rel residual {rel:.4e} (recomputed in f64 through the plain ELL product "
        f"{rel_check:.4e}, rounding floor {floor:.3e}), solutions bitwise equal "
        f"{torch.equal(xs, xs2)}; K2 launches {out['3D aux grid lane solve']}")
    check(rel <= 1e-8 and rel_check <= 1e-8 + floor and bool(torch.isfinite(xs).all()),
          "the 3D aux-grid solve did not reach 1e-8")
    check(its2 == its and torch.equal(xs, xs2), "the repeated 3D aux-grid solve differs from the first")
    check(out["3D aux grid lane solve"] > 0, "the 3D aux-grid path never launched K2")
    del model, E, aux, xs2, b, b_mod
    torch.cuda.empty_cache()

    # the same problem on the lattice numbering ("auto" takes the banded split)
    zero_launch_counts(ak, gs)
    ml = MatrixFreeElliptic((x, y, z), cells, bnd, K=1.0, gather_kernel="lane", device=DEVICE)
    bl = ml.load_vector(torch.ones(C, dtype=torch.float64, device=DEVICE))
    (xl, itl, rell), t_l = synced_seconds(lambda: ml.solve(bl, rtol=1e-10, maxiter=100))
    out["3D lattice banded solve"] = gs.ell_spmv_launches
    diff = ((xs - xl[pinv]).abs().max() / xl.abs().max()).item()
    log(f"27 the lattice numbering ({ml.preconditioner}): {itl} iterations in {t_l:.4f} s to rel "
        f"{float(rell):.3e}; max|x_scrambled - x_lattice (relabelled)| / max|x| = {diff:.3e}")
    check(ml.preconditioner == "banded_mg" and diff <= 1e-6, "the two numberings' solutions differ")
    del ml, xl, xs, bl, coords_s, cells_s, bnd_s
    torch.cuda.empty_cache()

    # MatrixFreeParabolic at n = 64: the banded route on the lattice, the
    # aux-grid route on a scrambled relabelling; trajectories equal
    nodes6, cells6, bnd6 = cube_mesh_device(N_PARA3D, 0.2, dtype=torch.float64, device=DEVICE)
    n6 = nodes6.shape[0]
    p6, pinv6 = scramble_perm(n6, *SCRAMBLE)
    trajectories = {}
    for route, (nodes_r, cells_r, bnd_r) in (
            ("banded_mg", (nodes6, cells6, bnd6)),
            ("auxgrid", (nodes6[pinv6], p6[cells6.long()].to(torch.int32), bnd6[pinv6]))):
        zero_launch_counts(ak, gs)
        mp, t_b = synced_seconds(lambda: MatrixFreeParabolic(nodes_r, cells_r, bnd_r, DT_PARA3D,
                                                             device=DEVICE))
        u0 = (torch.sin(np.pi * nodes_r[:, 0]) * torch.sin(np.pi * nodes_r[:, 1])
              * torch.sin(np.pi * nodes_r[:, 2]))
        (u, info), t_s = synced_seconds(lambda: mp.solve(u0, STEPS_PARA3D, rtol=1e-11, maxiter=400,
                                                         keep_trajectory=True))
        path = f"3D MatrixFreeParabolic {route}"
        out[path] = gs.ell_spmv_launches
        trajectories[route] = info["trajectory"]
        log(f"27 MatrixFreeParabolic n={N_PARA3D} ({n6} dofs) dt={DT_PARA3D:g}, {STEPS_PARA3D} steps "
            f"at rtol 1e-11: preconditioner {mp.preconditioner} ({type(mp.aux).__name__}); build "
            f"{t_b:.4f} s, steps {t_s:.4f} s, iterations {info['iterations']}, true rel residuals "
            f"max {max(info['rel_residuals']):.3e}; K2 launches {out[path]}")
        check(mp.preconditioner == route and max(info["rel_residuals"]) <= 1e-11,
              f"MatrixFreeParabolic 3D {route}")
        del mp
    ub = trajectories["banded_mg"]
    diffp = ((trajectories["auxgrid"] - ub[pinv6]).abs().max() / ub.abs().max()).item()
    log(f"27 MatrixFreeParabolic: max|u_aux - u_banded (relabelled)| / max|u| over the trajectory "
        f"= {diffp:.3e}")
    check(diffp <= 1e-8, "the 3D parabolic routes disagree")
    del nodes6, cells6, bnd6, trajectories, ub
    torch.cuda.empty_cache()

    # the PDE API on unit_cube_mesh(32): the default ladder takes the 3D
    # aux grid (as the JAX package's does, tests/test_torch_pde.py), and
    # u = x + 2y - z is reproduced
    mesh32 = unit_cube_mesh(N_CUBE_PDE)
    zero_launch_counts(ak, gs)
    pde = fdt.PDE(mesh32, -fdt.laplacian(), order=1, device=DEVICE)
    c = pde.dof_coords()
    g = c[:, 0] + 2 * c[:, 1] - c[:, 2]
    pde.set_dirichlet_bc(g)
    pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
    with Builds(AMG) as amg_builds, Builds(AuxGridPreconditioner3D) as aux_builds:
        xp, t_p = synced_seconds(pde.solve)
    out["3D PDE default ladder"] = gs.ell_spmv_launches
    errp = np.abs(xp.cpu().numpy().reshape(-1) - g).max() / np.abs(g).max()
    log(f"27 PDE(unit_cube_mesh({N_CUBE_PDE})) ({pde.n_dofs} dofs, {mesh32.n_cells} tets), default "
        f"preconditioner: 3D aux grids built {len(aux_builds)}, AMG hierarchies {len(amg_builds)}; "
        f"init + solve {t_p:.4f} s, {pde.solve_info.iterations} iterations; max|x - u| / max|u| = "
        f"{errp:.3e}; K2 launches {out['3D PDE default ladder']}")
    check(len(aux_builds) == 1 and len(amg_builds) == 0, "the 3D PDE did not take the 3D aux grid")
    check(pde.success and errp <= 1e-9, "the 3D PDE does not reproduce x + 2y - z to 1e-9")
    return out, tables


def sine_field():
    """u = sin(pi x) sin(pi y) as a port ScalarField (torch callable)."""
    from fdapde_core_tpu_torch.fields import ScalarField

    return ScalarField(lambda p: torch.sin(torch.pi * p[0]) * torch.sin(torch.pi * p[1]))


def phase_semilinear(ak, gs, ls, pts, cells, bnd):
    """solve_semilinear (BASELINE configuration 4) on phase 12's mesh with
    f from fields on the card; then the forced BFGS fallback on
    unit_square_mesh(N_BFGS). Returns ({path: (K2, K6 launches)}, the P1
    space, K2 backward launches)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace
    from fdapde_core_tpu_torch.geometry import unit_square_mesh
    from fdapde_core_tpu_torch.models import solve_semilinear

    out = {}
    t0 = time.perf_counter()
    space = FEMSpace(fdt.Triangulation(pts, cells, bnd), 1)
    q = torch.as_tensor(space.quadrature_nodes, device=DEVICE)
    space.scatter
    tables = [space.segment_sum(w, DEVICE) for w in ("matrix", "forcing")]
    t_space = time.perf_counter() - t0
    u = sine_field()
    H = u.derive_twice(mode="auto")
    (fq, uq), t_f = synced_seconds(lambda: (
        -torch.func.vmap(H)(q).diagonal(dim1=1, dim2=2).sum(1) + torch.func.vmap(u)(q) ** 3,
        torch.func.vmap(u)(q)))
    s = torch.sin(torch.pi * q[:, 0]) * torch.sin(torch.pi * q[:, 1])
    err_f = (fq - (2 * np.pi ** 2 * s + s ** 3)).abs().max().item()
    log(f"28 fields: f = -tr(ScalarField.derive_twice(mode='auto')) + u^3 at {q.shape[0]} quadrature "
        f"points on the card in {t_f:.4f} s; max|f - (2 pi^2 u + u^3)| = {err_f:.3e}")
    check(err_f <= 1e-12, "the fields' Hessian does not give the closed-form forcing to 1e-12")
    del tables

    zero_launch_counts(ak, gs)
    with Builds(gs.SlicedELL, "from_coo") as layouts:
        (x, info), t_solve = synced_seconds(lambda: solve_semilinear(
            space, -fdt.laplacian(), h=lambda v: v ** 3, dh=lambda v: 3 * v ** 2, forcing=fq,
            g=np.zeros(space.n_dofs), device=DEVICE))
    out["semilinear Newton"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    c = torch.as_tensor(space.dof_coords, device=DEVICE)
    err = (x - torch.sin(torch.pi * c[:, 0]) * torch.sin(torch.pi * c[:, 1])).abs().max().item()
    log(f"28 solve_semilinear -Lap u + u^3 = f nx={NX_PDE} ({space.n_dofs} dofs): host space and "
        f"tables {t_space:.4f} s, solve {t_solve:.4f} s; {info['newton_iterations']} Newton steps, "
        f"Jacobi CG iterations a step {info['cg_iterations']}, residuals "
        + ", ".join(f"{r:.3e}" for r in info["residuals"])
        + f"; max|u - sin sin| = {err:.3e} (bound {SEMILINEAR_BOUND:.3e}); K2 sliced layouts built "
        f"{len(layouts)}; K2 / K6 launches {out['semilinear Newton']}")
    check(info["method"] == "newton" and info["newton_iterations"] <= 8,
          f"Newton took {info['newton_iterations']} > 8 steps")
    check(info["residuals"][-1] < 1e-10, "the last Newton residual is not below 1e-10")
    check(bool(torch.isfinite(x).all()) and err < SEMILINEAR_BOUND, "the semilinear error exceeds its bound")
    check(len(layouts) == 1, f"K2's sliced pattern was built {len(layouts)} times, not once")
    check(out["semilinear Newton"][1] >= 1 and out["semilinear Newton"][0] > 0,
          "the semilinear path did not launch K6 and K2")

    sb = FEMSpace(unit_square_mesh(N_BFGS), 1)
    kw = dict(h=lambda v: v ** 3, dh=lambda v: 3 * v ** 2, g=np.zeros(sb.n_dofs), device=DEVICE,
              forcing=lambda p: 2 * np.pi ** 2 * np.sin(np.pi * p[..., 0]) * np.sin(np.pi * p[..., 1])
              + (np.sin(np.pi * p[..., 0]) * np.sin(np.pi * p[..., 1])) ** 3)
    un, _ = solve_semilinear(sb, -fdt.laplacian(), **kw)
    zero_launch_counts(ak, gs)
    (ub, ib), t_bfgs = synced_seconds(lambda: solve_semilinear(
        sb, -fdt.laplacian(), max_newton=1, newton_tol=1e-30, bfgs_fallback=True,
        H_potential=lambda v: v ** 4 / 4, **kw))
    out["semilinear BFGS fallback"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    backward = gs.ell_spmv_backward_launches
    diff = (ub - un).abs().max().item()
    log(f"28 BFGS fallback on unit_square_mesh({N_BFGS}) ({sb.n_dofs} dofs): method {ib['method']}, "
        f"{ib['bfgs_iterations']} BFGS iterations in {t_bfgs:.4f} s, max|u_bfgs - u_newton| = {diff:.3e}; "
        f"K2 / K6 launches {out['semilinear BFGS fallback']}, K2 backward launches {backward}")
    check(ib["method"] == "bfgs_fallback" and diff < 1e-4, "the BFGS fallback disagrees with Newton")
    check(backward > 0, "the BFGS fallback's gradient never launched K2's backward")
    return out, space, backward


def mixed_bc(space, device):
    """JAX's test_mixed_bc_quadratic_solution on a space: (A, F, Dirichlet
    mask, u = x^2) with du/dn = 2 on {x = 1} and Dirichlet data elsewhere."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import assemble_forcing, assemble_matrix
    from fdapde_core_tpu_torch.fem.neumann import assemble_neumann, boundary_facet_selector

    A = assemble_matrix(space, -fdt.laplacian(), device=device)
    F = assemble_forcing(space, lambda x: -2.0, device=device)
    side = boundary_facet_selector(space.mesh, lambda p: p[:, 0] > 1.0 - 1e-9)
    F = F + assemble_neumann(space, 2.0, side, device=device)
    coords = space.dof_coords
    dmask = space.boundary_dofs.copy()
    corner = (coords[:, 1] < 1e-9) | (coords[:, 1] > 1 - 1e-9)
    dmask &= ~((coords[:, 0] > 1.0 - 1e-9) & ~corner)
    return A, F, torch.as_tensor(dmask, device=device), torch.as_tensor(coords[:, 0] ** 2, device=device)


def phase_neumann(ak, gs, ls, pts, cells, bnd, space1, space2):
    """Mixed Dirichlet/Neumann data (BASELINE configuration 2) on phase 12's
    mesh, P1 and P2 (phase 24's space), through solve_elliptic; the
    boundary-length and unit-area identities; the host P2 FEMSpace with the
    native hash pass and with the NumPy one. Returns {path: (K2, K6)}."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, solve_elliptic
    from fdapde_core_tpu_torch.fem.neumann import assemble_neumann, boundary_facet_selector
    from fdapde_core_tpu_torch.geometry import triangulation as ttri
    from fdapde_core_tpu_torch.native import native_available, topology
    from fdapde_core_tpu_torch.utils.integration import integrate

    out = {}
    for order, space, bound in ((1, space1, NEUMANN_P1_BOUND), (2, space2, 1e-9)):
        zero_launch_counts(ak, gs)
        (A, F, dmask, u), t_asm = synced_seconds(lambda: mixed_bc(space, DEVICE))
        (x, info), t_solve = synced_seconds(lambda: solve_elliptic(
            A, F, dmask, u, rtol=1e-13, preconditioner=None, recovery=False))
        out[f"Neumann P{order}"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
        err = (x - u).abs().max().item()
        log(f"29 mixed Dirichlet/Neumann u = x^2, du/dn = 2 on x = 1, P{order} ({space.n_dofs} dofs): "
            f"assembly {t_asm:.4f} s, solve {t_solve:.4f} s (Jacobi CG), "
            f"{info.iterations} iterations, converged {info.converged}; max|x - x^2| = {err:.3e} "
            f"(bound {bound:.1e}); K2 / K6 launches {out[f'Neumann P{order}']}")
        check(info.converged and err < bound, f"P{order} mixed Neumann data not reproduced within {bound}")
        del A, F, x
    check(out["Neumann P1"][1] >= 1, "the Neumann P1 assembly did not launch K6")
    whole = boundary_facet_selector(space1.mesh, lambda p: p[:, 0] > -1.0)
    length = float(assemble_neumann(space1, 1.0, whole, device=DEVICE).sum())
    area = integrate(space1.mesh, lambda p: 1.0)
    log(f"29 assemble_neumann(1, whole boundary).sum() = {length:.15f} (4), integrate(mesh, 1) = {area:.15f}")
    check(abs(length - 4.0) <= 1e-12 and abs(area - 1.0) <= 1e-12, "boundary length / area identity")

    check(native_available(), "the native library cannot be built on this machine (no g++)")
    spaces = {}
    for path in ("native", "numpy"):
        topology.native_calls = 0
        raw = ttri.first_encounter_unique
        if path == "numpy":
            ttri.first_encounter_unique = ttri.first_encounter_unique_numpy
        try:
            t0 = time.perf_counter()
            sp = FEMSpace(fdt.Triangulation(pts, cells, bnd), order=2)
            sp.dof_coords
            spaces[path] = (sp, time.perf_counter() - t0, topology.native_calls)
        finally:
            ttri.first_encounter_unique = raw
    (sn, tn, cn), (sp, tp, cp) = spaces["native"], spaces["numpy"]
    same = (np.array_equal(sn.mesh.edges, sp.mesh.edges) and np.array_equal(sn.dofs, sp.dofs)
            and np.array_equal(sn.boundary_dofs, sp.boundary_dofs))
    log(f"29 host FEMSpace(order=2) nx={NX_PDE}: native hash pass {tn:.4f} s ({cn} native calls), "
        f"NumPy sort {tp:.4f} s ({cp}); edges, dof tables and boundary equal {same}")
    check(cn > 0 and cp == 0 and same, "the native and NumPy P2 spaces differ or the native path was not taken")
    return out


def fem_misfit(A, M, F, mask, target, mm=None, record=None, pre=None):
    """loss(kappa) = |u(kappa) - target|^2 with u solving the masked
    (kappa A + M) u = F by cg_differentiable; mm(S, v) the product (S @ v
    by default, on K2)."""
    from fdapde_core_tpu_torch.linear_algebra import cg_differentiable

    mm = mm or (lambda S, v: S @ v)
    free = (~mask).to(F.dtype)

    def loss(kappa, M=M):
        def matvec(x):
            return (kappa * mm(A, x * free) + mm(M, x * free)) * free + x * mask

        x = cg_differentiable(matvec, F * free, M_inv=pre, rtol=1e-13, record=record)
        return torch.sum((x - target) ** 2)

    return loss


def phase_differentiable(ak, gs, ls, space1):
    """cg_differentiable at full width on phase 12's mesh (a diffusion
    coefficient, a direction in a weighted mass matrix's values, K2's
    backward against a forward on the same table), the inverse problem by
    newton at nx = N_INVERSE, and the FSPAI rung at nx = N_FSPAI. Returns
    ({path: (K2, K6)}, K2 backward launches, the backward's timing)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_forcing, assemble_matrix, solve_elliptic
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.linear_algebra import jacobi_preconditioner
    from fdapde_core_tpu_torch.optimization import newton

    fspai_mod = sys.modules["fdapde_core_tpu_torch.linear_algebra.fspai"]
    out, backward = {}, 0
    A = assemble_matrix(space1, -fdt.laplacian(), device=DEVICE)
    M = assemble_matrix(space1, fdt.reaction(1.0), device=DEVICE)
    F = assemble_forcing(space1, lambda p: 1.0, device=DEVICE)
    mask = torch.as_tensor(space1.boundary_dofs, device=DEVICE)
    c = torch.as_tensor(space1.dof_coords, device=DEVICE)
    target = torch.sin(torch.pi * c[:, 0]) * torch.sin(torch.pi * c[:, 1])
    pre = jacobi_preconditioner(DirichletSystem(A * 2.0 + M, mask).diagonal())
    record = []
    loss = fem_misfit(A, M, F, mask, target, record=record, pre=pre)
    kappa = torch.tensor(2.0, dtype=torch.float64, device=DEVICE, requires_grad=True)
    zero_launch_counts(ak, gs)
    (g,), t_grad = synced_seconds(lambda: torch.autograd.grad(loss(kappa), kappa))
    out["cg_differentiable kappa"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    bw = gs.ell_spmv_backward_launches
    backward += bw
    its = [(k, i.iterations) for k, i in record]
    eps = 1e-4
    with torch.no_grad():
        fd = (float(loss(2.0 + eps)) - float(loss(2.0 - eps))) / (2 * eps)
    rel = abs(float(g) - fd) / abs(fd)
    log(f"30 d|u(kappa) - target|^2 / dkappa nx={NX_PDE} ({space1.n_dofs} dofs): {float(g):.12e} "
        f"in {t_grad:.4f} s, central difference {fd:.12e} (rel {rel:.3e}); solves (kind, iterations) "
        f"{its}; K2 launches {out['cg_differentiable kappa'][0]}, of them backward {bw}")
    check(rel <= 1e-4, "dloss/dkappa disagrees with its finite difference")
    check(its[1][0] == "adjoint" and abs(its[1][1] - its[0][1]) <= 0.2 * its[0][1],
          "the adjoint solve's iterations are not about the forward's")
    check(bw > 0, "the gradient never launched K2's backward")

    # a direction d in the (nnz,) values of the mass matrix weighted by
    # w = 1 + x y: d/ds loss(M_w + s d) through K2 and through its plain version
    Mw = assemble_matrix(space1, fdt.reaction(lambda p: 1.0 + p[..., 0] * p[..., 1]), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    # each value moved by 50-150 % of its size a unit of s
    d = (torch.rand(Mw.nnz, generator=gen, dtype=torch.float64, device=DEVICE) + 0.5) * Mw.vals.abs()
    grads = {}
    for route, mm in (("K2", None), ("plain", lambda S, v: S.matmul_reference(v))):
        rec = []
        lw = fem_misfit(A, Mw, F, mask, target, mm=mm, record=rec, pre=pre)
        s = torch.zeros((), dtype=torch.float64, device=DEVICE, requires_grad=True)
        zero_launch_counts(ak, gs)
        (gs_,), t = synced_seconds(lambda: torch.autograd.grad(lw(2.0, M=Mw.with_vals(Mw.vals + s * d)), s))
        grads[route] = (float(gs_), t, [(k, i.iterations) for k, i in rec], gs.ell_spmv_launches,
                        gs.ell_spmv_backward_launches)
    eps_w = 1e-5
    with torch.no_grad():
        fdw = (float(lw(2.0, M=Mw.with_vals(Mw.vals + eps_w * d)))
               - float(lw(2.0, M=Mw.with_vals(Mw.vals - eps_w * d)))) / (2 * eps_w)
    gk, gp = grads["K2"][0], grads["plain"][0]
    out["cg_differentiable mass values"] = (grads["K2"][3], 0)
    backward += grads["K2"][4]
    log(f"30 directional derivative in the weighted mass matrix's {Mw.nnz} values: K2 {gk:.12e} "
        f"({grads['K2'][1]:.4f} s, solves {grads['K2'][2]}, K2 launches {grads['K2'][3]}, backward "
        f"{grads['K2'][4]}), K2's plain version {gp:.12e} ({grads['plain'][1]:.4f} s, K2 launches "
        f"{grads['plain'][3]}): rel {abs(gk - gp) / abs(gp):.3e}; central difference {fdw:.12e} "
        f"(rel {abs(gk - fdw) / abs(fdw):.3e})")
    check(abs(gk - gp) <= 1e-10 * abs(gp), "the K2 gradient differs from its plain version's")
    check(abs(gk - fdw) <= 1e-4 * abs(fdw), "the mass-values gradient disagrees with its finite difference")
    check(grads["plain"][3] == 0 and grads["K2"][4] > 0, "the routes did not take their products")

    # K2's backward against a forward on the same table: A^T G on the
    # transpose's sliced form (built once per pattern) and A x
    v = torch.rand(A.shape[1], generator=gen, dtype=torch.float64, device=DEVICE)
    At = A.transpose_with(A.vals[A.transpose_order()])
    fwd = lambda: A.sliced() @ v  # noqa: E731
    bwd = lambda: At.sliced() @ v  # noqa: E731
    plain = lambda: At.matmul_reference(v)  # noqa: E731
    ref = plain()
    err = (bwd() - ref).abs().max().item()
    scale = At.with_vals(At.vals.abs()).matmul_reference(v.abs())
    bound_err = bool(((bwd() - ref).abs() <= At.sliced().width * torch.finfo(torch.float64).eps * scale).all())
    f1, b1, p1 = time_ms(fwd, 20), time_ms(bwd, 20), time_ms(plain, 3)
    f2, b2, p2 = time_ms(fwd, 20), time_ms(bwd, 20), time_ms(plain, 3)
    n, nnz = A.shape[0], A.nnz
    bnd_t = least_time(nnz * 12 + 2 * n * 8, 2 * nnz, torch.float64)
    lib = A.to_scipy().T.tocsr()
    Acsr = torch.sparse_csr_tensor(torch.as_tensor(lib.indptr, device=DEVICE),
                                   torch.as_tensor(lib.indices, device=DEVICE),
                                   torch.as_tensor(lib.data, device=DEVICE), size=lib.shape)
    l1, l2 = time_ms(lambda: Acsr @ v, 20), time_ms(lambda: Acsr @ v, 20)
    # the whole backward call: autograd's dX = A^T G for y = A x, the
    # launch on A.T's cached sliced form with the engine's own work
    xr = v.clone().requires_grad_(True)
    y = A @ xr
    call = lambda: torch.autograd.grad(y, xr, v, retain_graph=True)  # noqa: E731
    call_err = (call()[0] - ref).abs().max().item()
    c1, c2 = time_ms(call, 20), time_ms(call, 20)
    _, t_calls = synced_seconds(lambda: [call() for _ in range(200)])
    timing = dict(table=f"A^T, phase 12's P1 Laplacian ({n} x {n}, {nnz} entries), f64", ms=(b1 + b2) / 2,
                  call_ms=(c1 + c2) / 2, call_host_ms=t_calls * 5, forward_ms=(f1 + f2) / 2,
                  plain_ms=(p1 + p2) / 2, library_ms=(l1 + l2) / 2, max_abs_err=err, **bnd_t)
    log(f"30 K2 backward (A^T v on the transpose's sliced form) {b1:.4f} / {b2:.4f} ms against the "
        f"forward A v {f1:.4f} / {f2:.4f} ms on the same table; the whole autograd backward call "
        f"{c1:.4f} / {c2:.4f} ms on the card, {t_calls * 5:.4f} ms on the host's clock (max|call-plain| "
        f"{call_err:.3e}); plain {p1:.4f} / {p2:.4f} ms, "
        f"torch.sparse CSR {l1:.4f} / {l2:.4f} ms; bound {bnd_t['bound_ms']:.4f} ms ({bnd_t['bound_by']}); "
        f"max|kernel-plain| {err:.3e}, within the per-row bound {bound_err}")
    check(call_err <= err, "the autograd backward call differs from the backward product")
    check(bound_err, "K2's backward product disagrees with its plain version")
    del A, M, Mw, At, Acsr, d, v, xr, y

    # the inverse problem (JAX's test_coefficient_estimation_inverse_problem)
    zero_launch_counts(ak, gs)
    res, t_inv, rec, dofs = inverse_problem(N_INVERSE, lambda: zero_launch_counts(ak, gs))
    out["inverse problem"] = (gs.ell_spmv_launches, 0)
    backward += gs.ell_spmv_backward_launches
    kx = float(res.x[0])
    log(f"30 inverse problem on delaunay_mesh({N_INVERSE}) ({dofs} dofs): newton kappa = {kx:.12f} "
        f"(kappa* = 3) in {res.n_iter} iterations, {t_inv:.4f} s, {len(rec)} solves, "
        f"{sum(i.iterations for _, i in rec)} CG iterations; K2 launches {out['inverse problem'][0]}, "
        f"backward {gs.ell_spmv_backward_launches}")
    check(abs(kx - 3.0) <= 1e-6, "the inverse problem did not recover kappa* = 3 to 1e-6")
    # an x0 that is not a tensor lands on the card, as JAX's jnp.asarray
    # puts it on the accelerator
    on_card = newton(lambda x: torch.sum((x - 2.0) ** 2), [1.0])
    log(f"30 newton(f, [1.0]) -> x {on_card.x.tolist()} on {on_card.x.device}")
    check(on_card.x.device.type == "cuda" and abs(float(on_card.x[0]) - 2.0) <= 1e-12,
          "newton on a list x0 did not run on the card")

    # the FSPAI rung of the recovery step
    pf, cf, bf = delaunay_mesh(N_FSPAI)
    sf = FEMSpace(fdt.Triangulation(pf, cf, bf), 1)
    Af = assemble_matrix(sf, -fdt.laplacian(), device=DEVICE)
    mf = torch.as_tensor(sf.boundary_dofs, device=DEVICE)
    bf_ = torch.ones(sf.n_dofs, dtype=torch.float64, device=DEVICE) / sf.n_dofs
    zf = torch.zeros_like(bf_)
    fspai_mod.native_calls = 0
    zero_launch_counts(ak, gs)
    with Builds(fspai_mod, "fspai") as setups, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (xf, info), t_f = synced_seconds(lambda: solve_elliptic(Af, bf_, mf, zf, rtol=1e-10,
                                                                maxiter=FSPAI_MAXITER))
    out["FSPAI recovery"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    msgs = [str(w.message) for w in caught]
    sysf = DirichletSystem(Af, mf)
    rhs = sysf.rhs(bf_, zf)
    true = float(torch.linalg.norm(rhs - sysf(xf)) / torch.linalg.norm(rhs))
    t_setup = setups[0][1] if setups else float("nan")
    nnz_l = setups[0][0].nnz if setups else 0
    log(f"30 FSPAI recovery on delaunay_mesh({N_FSPAI}) ({sf.n_dofs} dofs), maxiter {FSPAI_MAXITER}: "
        f"warnings {msgs}; FSPAI host set-up {t_setup:.4f} s (native calls {fspai_mod.native_calls}), "
        f"L nnz {nnz_l}; solve {t_f:.4f} s, {info.iterations} GMRES iterations, converged "
        f"{info.converged}, true rel residual {true:.3e}; K2 launches {out['FSPAI recovery'][0]}")
    check(any("FSPAI" in m for m in msgs), "the recovery step did not take the FSPAI rung")
    check(fspai_mod.native_calls == 1 and len(setups) == 1, "FSPAI did not take the native library")
    check(info.converged and true <= 1e-9, "the FSPAI-preconditioned GMRES did not converge to 1e-9")
    return out, backward, timing


def inverse_problem(nx, zero_counts=lambda: None):
    """JAX's test_coefficient_estimation_inverse_problem on delaunay_mesh(nx):
    u_obs solves kappa* A u = 4 (kappa* = 3, zero Dirichlet data) by
    cg_differentiable; optimization.newton from kappa = 1 minimises
    |u(kappa) - u_obs|^2, its Hessian through the solve. zero_counts runs
    just before newton. Returns (OptimizeResult, newton's seconds, the
    solves' (kind, SolveInfo) record, dofs)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_forcing, assemble_matrix
    from fdapde_core_tpu_torch.linear_algebra import cg_differentiable
    from fdapde_core_tpu_torch.optimization import newton

    ps, cs, bs = delaunay_mesh(nx)
    si = FEMSpace(fdt.Triangulation(ps, cs, bs), 1)
    Ai = assemble_matrix(si, -fdt.laplacian(), device=DEVICE)
    Fi = assemble_forcing(si, lambda p: 4.0, device=DEVICE)
    mi = torch.as_tensor(si.boundary_dofs, device=DEVICE)
    free = (~mi).to(Fi.dtype)
    rec = []

    def solve_for(k):
        return cg_differentiable(lambda v: k * (Ai @ (v * free)) * free + v * mi, Fi * free,
                                 rtol=1e-13, record=rec)

    u_obs = solve_for(3.0)
    rec.clear()
    zero_counts()
    res, t = synced_seconds(lambda: newton(lambda k: torch.sum((solve_for(k) - u_obs) ** 2),
                                           torch.tensor([1.0], dtype=torch.float64, device=DEVICE),
                                           tol=1e-12, max_iter=50))
    return res, t, rec, si.n_dofs


def lifted_true_residual(pde, x, g):
    """The true relative residual of a PDE's system with Dirichlet data g
    moved to the right-hand side (DirichletSystem.rhs), recomputed on the
    host in f64."""
    A = pde.stiff().to_scipy()
    bd = pde.space.boundary_dofs
    free = ~bd
    xh = x.cpu().numpy().reshape(-1)
    gb = np.where(bd, g, 0.0)
    b_mod = free * (pde.force().cpu().numpy().reshape(-1) - A @ gb) + gb
    r = b_mod - (free * (A @ (free * xh)) + bd * xh)
    return float(np.linalg.norm(r) / np.linalg.norm(b_mod))


def ladder_solve(pde):
    """pde.solve() with the "auto" ladder's rungs watched: (solution,
    seconds, rung, aux-grid builds, AMG builds, whether the recovery step
    ran). The rung is "auxgrid" when one aux grid was built and no AMG
    hierarchy, "amg" when the aux grid's build raised and one hierarchy was
    built."""
    from fdapde_core_tpu_torch.linear_algebra.amg import AMG
    from fdapde_core_tpu_torch.ops.auxgrid import AuxGridPreconditioner

    aux = Builds(AuxGridPreconditioner)
    with aux as aux_b, Builds(AMG) as amg_b, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x, t = synced_seconds(pde.solve)
    recovered = any("escalating to GMRES" in str(w.message) for w in caught)
    rung = ("auxgrid" if len(aux_b) == 1 and not amg_b and not aux.failed else
            "amg" if len(amg_b) == 1 and not aux_b and len(aux.failed) == 1 else "other")
    return x, t, rung, (aux_b, aux.failed), amg_b, recovered


def trace_kernels(trace_dir):
    """Names of the CUDA kernels in the Chrome trace xprof_trace wrote."""
    (path,) = Path(trace_dir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"], path.stat().st_size


def phase_network(ak, gs, ls, scratch):
    """31a: the street network of phase 12's lattice (519,841 junctions,
    1,038,240 segments) through PDE(LinearNetwork(...)) with the default
    ladder at NETWORK_RTOL, constant data and g = x + y, timed by utils.profiling.timer
    against CUDA events; the same construction at NX_NETWORK_SMALL on
    JAX's rung and count, and one of its solves traced by xprof_trace.
    Returns ({path: (K2, K6)}, the solutions)."""
    import shutil

    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.utils.profiling import timer, xprof_trace

    out, solutions = {}, []
    (pts, segs, bnd), t_build = synced_seconds(lambda: street_network(NX_PDE))
    net, t_net = synced_seconds(lambda: fdt.LinearNetwork(pts, segs, bnd))
    check((net.n_nodes, net.n_cells) == ((NX_PDE + 1) ** 2, 2 * NX_PDE * (NX_PDE + 1)),
          f"the network has {net.n_nodes} junctions and {net.n_cells} segments")
    for name, g_of in (("constant 2.5", lambda c: np.full(c.shape[0], 2.5)),
                       ("g = x + y", lambda c: c[:, 0] + c[:, 1])):
        zero_launch_counts(ak, gs)
        t0 = time.perf_counter()
        pde = fdt.PDE(net, -fdt.laplacian(), order=1, solver_rtol=NETWORK_RTOL, device=DEVICE)
        g = g_of(pde.dof_coords())
        pde.set_dirichlet_bc(g)
        pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
        pde.init()
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        store = {}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timer("solve", store, sync=pde.force()):
            start.record()
            x, t_solve, rung, (aux_b, _), amg_b, recovered = ladder_solve(pde)
            end.record()
        end.synchronize()
        t_events = start.elapsed_time(end) / 1e3
        k2, k6 = gs.ell_spmv_launches, ls.p1_stiffness_2d_launches
        out[f"network {name}"] = (k2, k6)
        info = pde.solve_info
        rel = lifted_true_residual(pde, x, g)
        gb = g[bnd]
        lo, hi = x.min().item(), x.max().item()
        log(f"31a street network nx={NX_PDE} ({net.n_nodes} junctions, {net.n_cells} segments; "
            f"lattice {t_build:.4f} s, LinearNetwork {t_net:.4f} s), {name}: host set-up (space, "
            f"assembly) {t_setup:.4f} s; rung {rung} (aux grid {aux_b[0][0].n_grid if aux_b else None}"
            f" built in {aux_b[0][1] if aux_b else 0:.4f} s, AMG hierarchies {len(amg_b)}), "
            f"{info.iterations} iterations, converged {info.converged}, recovery taken {recovered}, "
            f"solve {t_solve:.4f} s (timer {store['solve']:.4f} s, CUDA events {t_events:.4f} s); "
            f"true rel residual (host f64) {rel:.4e}; solution in [{lo:.17g}, {hi:.17g}] against the "
            f"data's [{gb.min():.17g}, {gb.max():.17g}]; K2 launches {k2}, K6 launches {k6}")
        check(rung == "auxgrid", f"the network solve took the {rung} rung, JAX's takes the aux grid")
        check(info.converged and not recovered, f"the network solve ({name}) did not converge")
        check(rel <= 1e-8, f"network true relative residual {rel:.3e} > 1e-8")
        check(store["solve"] >= t_events, "timer read less than the CUDA events of its block")
        check(k2 > 0, "the network path never launched K2")
        if name.startswith("constant"):
            err = (x - 2.5).abs().max().item()
            check(err <= 1e-10, f"the constant is reproduced to {err:.3e} only")
        else:
            check(gb.min() - 1e-8 <= lo and hi <= gb.max() + 1e-8,
                  "the network solution leaves the boundary data's range")
        solutions.append(x)
    k2_table(gs, "network stiffness", pde.stiff(), race=False)
    del pde, net

    ps, ss, bs = street_network(NX_NETWORK_SMALL)
    zero_launch_counts(ak, gs)
    pde = fdt.PDE(fdt.LinearNetwork(ps, ss, bs), -fdt.laplacian(), order=1, device=DEVICE)
    c = pde.dof_coords()
    pde.set_dirichlet_bc(c[:, 0] + c[:, 1])
    pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
    x, t_solve, rung, _, _, recovered = ladder_solve(pde)
    its = pde.solve_info.iterations
    out[f"network nx={NX_NETWORK_SMALL}"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    log(f"31a street network nx={NX_NETWORK_SMALL} ({pde.n_dofs} junctions): rung {rung}, {its} "
        f"iterations in {t_solve:.4f} s (the JAX package's ladder on the CPU: {NETWORK_JAX_RUNG})")
    check(rung == NETWORK_JAX_RUNG[0] and not recovered and pde.success,
          f"the nx={NX_NETWORK_SMALL} network took the {rung} rung")
    check(abs(its - NETWORK_JAX_RUNG[1]) <= NETWORK_JAX_RUNG[1] // 10,
          f"the nx={NX_NETWORK_SMALL} network took {its} iterations, JAX's {NETWORK_JAX_RUNG[1]}")
    solutions.append(x)
    # the trace of a network small enough for a short trace (Jacobi CG)
    ps, ss, bs = street_network(NX_NETWORK_TRACE)
    pde = fdt.PDE(fdt.LinearNetwork(ps, ss, bs), -fdt.laplacian(), order=1, device=DEVICE)
    pde.set_dirichlet_bc(np.full(pde.n_dofs, 2.5))
    pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
    pde.init()
    trace_dir = scratch / "trace"
    with xprof_trace(str(trace_dir)):
        pde.solve()
    names, size = trace_kernels(trace_dir)
    k2_names = sorted({n for n in names if "ell_spmv_kernel" in n or "sell_" in n})
    log(f"31e xprof_trace of one nx={NX_NETWORK_TRACE} network solve ({pde.solve_info.iterations} "
        f"iterations): {size / 2**20:.1f} MiB, "
        f"{len(names)} CUDA kernel events, K2's among them: {len(k2_names)} kernels "
        f"({'; '.join(n[:60] for n in k2_names)})")
    check(k2_names, "the trace lists no K2 kernel")
    shutil.rmtree(trace_dir)
    return out, solutions


def phase_interval(ak, gs, ls):
    """31b: 1D P1 at N_INTERVAL cells and P2 at N_INTERVAL_P2, -u'' = pi^2 sin(pi x), g = 0,
    the default ladder: the aux grid's build raises on 1-column
    coordinates and SA-AMG solves, as in JAX; u = x on unit_interval_mesh.
    Returns ({path: (K2, K6)}, the solutions)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.geometry import unit_interval_mesh

    out, solutions = {}, []
    for order, n_cells in ((1, N_INTERVAL), (2, N_INTERVAL_P2)):
        zero_launch_counts(ak, gs)
        pde, t_space = synced_seconds(lambda: fdt.PDE(fdt.Interval(0.0, 1.0, n_cells),
                                                      -fdt.laplacian(), order=order, device=DEVICE))
        q = pde.quadrature_nodes()
        pde.set_forcing(np.pi ** 2 * np.sin(np.pi * q[:, 0]))
        pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
        _, t_init = synced_seconds(pde.init)
        x, t_solve, rung, (_, failed), amg_b, recovered = ladder_solve(pde)
        its = pde.solve_info.iterations
        err = (x - torch.as_tensor(np.sin(np.pi * pde.dof_coords()[:, 0]), device=DEVICE)).abs().max().item()
        out[f"1D P{order}"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
        mg = amg_b[0][0] if amg_b else None
        log(f"31b Interval(0, 1, {n_cells}) P{order} ({pde.n_dofs} dofs): space {t_space:.4f} s, "
            f"init {t_init:.4f} s; rung {rung} (aux grid raised {[type(e).__name__ for e in failed]}; "
            f"AMG set-up {amg_b[0][1] if amg_b else 0:.4f} s, levels {mg.level_sizes() if mg else None}), "
            f"{its} iterations, converged {pde.success}, recovery taken {recovered}, solve "
            f"{t_solve:.4f} s; max error {err:.4e}; K2 launches {out[f'1D P{order}'][0]} (the JAX "
            f"package's P1 on the CPU: {INTERVAL_JAX_RUNG})")
        check(rung == "amg" and isinstance(failed[0], IndexError),
              f"the 1D ladder took the {rung} rung, JAX's takes SA-AMG after the aux grid raises")
        check(pde.success and not recovered, f"the 1D P{order} solve did not converge without recovery")
        if order == 1:
            check(err <= 1e-11, f"1D P1 max error {err:.3e} > 1e-11")
            check(abs(its - INTERVAL_JAX_RUNG[1]) <= INTERVAL_JAX_RUNG[1] // 10,
                  f"1D P1 took {its} iterations, JAX's {INTERVAL_JAX_RUNG[1]}")
            k2_table(gs, "1D P1 stiffness", pde.stiff(), race=False)
        solutions.append(x)
    zero_launch_counts(ak, gs)
    pde = fdt.PDE(unit_interval_mesh(N_INTERVAL), -fdt.laplacian(), order=1, device=DEVICE)
    g = pde.dof_coords()[:, 0].copy()
    pde.set_dirichlet_bc(g)
    pde.set_forcing(np.zeros(pde.quadrature_nodes().shape[0]))
    x, t_solve, rung, _, _, _ = ladder_solve(pde)
    err = (x - torch.as_tensor(g, device=DEVICE)).abs().max().item()
    out["1D u = x"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    log(f"31b u = x on unit_interval_mesh({N_INTERVAL}): rung {rung}, {pde.solve_info.iterations} "
        f"iterations in {t_solve:.4f} s, max|x - g| = {err:.3e}")
    check(pde.success and err <= 1e-9, f"u = x reproduced to {err:.3e} only")
    solutions.append(x)
    return out, solutions


def phase_checkpoints(ak, gs, ls, pts, cells, bnd, amg_run, scratch):
    """31c: phase 21a's SA-AMG hierarchy saved and loaded back on the card
    (V-cycle bitwise, and phase 21a's solve through it bitwise); phase 12's
    P1 FEMSpace saved and loaded (assemble_matrix through K6 bitwise).
    Returns ({path: (K2, K6)}, the solutions)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_matrix
    from fdapde_core_tpu_torch.utils.checkpoint import load_amg, load_space, save_amg, save_space

    out = {}
    mg, t_setup, x21, its21 = amg_run
    path = scratch / "amg.npz"
    _, t_save = synced_seconds(lambda: save_amg(str(path), mg))
    loaded, t_load = synced_seconds(lambda: load_amg(str(path), device=DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    r = torch.rand(mg.As[0].shape[0], generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    same_v = torch.equal(loaded.v_cycle(r), mg.v_cycle(r))
    log(f"31c SA-AMG checkpoint of phase 21a ({mg.level_sizes()}): host set-up {t_setup:.4f} s, "
        f"save {t_save:.4f} s ({path.stat().st_size / 2**20:.1f} MiB), load {t_load:.4f} s; "
        f"restored V-cycle == original bitwise {same_v}")
    check(same_v, "the restored V-cycle differs from the original")
    del mg
    zero_launch_counts(ak, gs)
    pde = fdt.PDE(fdt.Triangulation(pts, cells, bnd), -fdt.laplacian(), order=1,
                  solver_preconditioner=loaded.v_cycle, device=DEVICE)
    q = pde.quadrature_nodes()
    pde.set_forcing(2 * np.pi ** 2 * np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1]))
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    pde.init()
    x, t_solve = synced_seconds(pde.solve)
    out["restored AMG PDE"] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    same_x = torch.equal(x, x21)
    log(f"31c PDE(solver_preconditioner=loaded.v_cycle): {pde.solve_info.iterations} iterations "
        f"(phase 21a: {its21}) in {t_solve:.4f} s; solution == phase 21a's bitwise {same_x}")
    check(pde.success and pde.solve_info.iterations == its21 and same_x,
          "the restored hierarchy does not reproduce phase 21a's solve")
    solutions = [x]
    del pde, loaded, x21

    mesh = fdt.Triangulation(pts, cells, bnd)
    space, t_space = synced_seconds(lambda: FEMSpace(mesh, 1))
    _, t_scatter = synced_seconds(lambda: space.scatter)
    path = scratch / "space.npz"
    _, t_save = synced_seconds(lambda: save_space(str(path), space))
    loaded, t_load = synced_seconds(lambda: load_space(str(path)))
    A0 = assemble_matrix(space, -fdt.laplacian(), device=DEVICE)
    zero_launch_counts(ak, gs)
    A1, t_asm = synced_seconds(lambda: assemble_matrix(loaded, -fdt.laplacian(), device=DEVICE))
    k6 = ls.p1_stiffness_2d_launches
    out["loaded space assembly"] = (gs.ell_spmv_launches, k6)
    same = (torch.equal(A1.rows, A0.rows) and torch.equal(A1.cols, A0.cols)
            and torch.equal(A1.vals, A0.vals))
    log(f"31c FEMSpace checkpoint of phase 12's mesh ({space.n_dofs} dofs): build {t_space:.4f} s + "
        f"scatter tables {t_scatter:.4f} s, save {t_save:.4f} s ({path.stat().st_size / 2**20:.1f} "
        f"MiB), load {t_load:.4f} s; assemble_matrix on the loaded space {t_asm:.4f} s (its "
        f"segment_sum tables built there), == the original's bitwise {same}; K6 launches {k6}")
    check(same and k6 >= 1, "assembly on the loaded space differs, or did not launch K6")
    return out, solutions


def write_r_csv(path, columns, names, fmt):
    """An R-style CSV: a quoted header with an empty first field, quoted
    row names, then the columns."""
    table = np.column_stack([np.arange(1, len(columns[0]) + 1)] + list(columns))
    np.savetxt(path, table, fmt=['"%d"'] + fmt, delimiter=",",
               header=",".join(['""'] + [f'"{n}"' for n in names]), comments="")


def phase_io(ak, gs, ls, scratch):
    """31d: a stiffness matrix through an R-style COO CSV into a card
    SparseMatrix (bitwise, K2 bitwise, Jacobi CG to 1e-10); the mesh
    through load_mesh_csv; read_mtx against the dense form. Returns
    ({path: (K2, K6)}, the solutions)."""
    from scipy.io import mmwrite

    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_matrix, solve_elliptic
    from fdapde_core_tpu_torch.geometry import unit_square_mesh
    from fdapde_core_tpu_torch.utils.io import load_mesh_csv, read_csv_sparse, read_mtx

    ps, cs, bs = delaunay_mesh(N_IO_MESH)
    space = FEMSpace(fdt.Triangulation(ps, cs, bs), 1)
    A = assemble_matrix(space, -fdt.laplacian(), device=DEVICE)
    path = scratch / "stiffness.csv"
    r, c, v = (t.cpu().numpy() for t in (A.rows, A.cols, A.vals))
    _, t_write = synced_seconds(lambda: write_r_csv(path, [r + 1, c + 1, v], ["i", "j", "x"],
                                                    ["%d", "%d", "%.17g"]))
    zero_launch_counts(ak, gs)
    B, t_read = synced_seconds(lambda: read_csv_sparse(str(path), shape=A.shape, device=DEVICE))
    equal = torch.equal(B.rows, A.rows) and torch.equal(B.cols, A.cols) and torch.equal(B.vals, A.vals)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
    x = torch.rand(A.shape[1], generator=gen, dtype=torch.float64, device=DEVICE)
    same_k2 = torch.equal(B @ x, A @ x)
    mask = torch.as_tensor(space.boundary_dofs, device=DEVICE)
    b = torch.where(mask, 0.0, 1.0 / A.shape[0]).to(torch.float64)
    u, info = solve_elliptic(B, b, mask, torch.zeros_like(b), rtol=1e-10, recovery=False)
    out = {"CSV matrix": (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)}
    log(f"31d R-style COO CSV of delaunay_mesh({N_IO_MESH})'s stiffness ({A.shape[0]} dofs, {A.nnz} "
        f"entries, {path.stat().st_size / 2**20:.1f} MiB): written {t_write:.4f} s, "
        f"read_csv_sparse(device='cuda') {t_read:.4f} s; rows, cols, vals == bitwise {equal}; K2 "
        f"on it == the original's bitwise {same_k2}; Jacobi CG to 1e-10: {info.iterations} "
        f"iterations, converged {info.converged}; K2 launches {out['CSV matrix'][0]}")
    check(equal and same_k2, "the CSV-read matrix differs from the original")
    check(info.converged, "Jacobi CG on the CSV-read matrix did not converge")

    mdir = scratch / "mesh"
    mdir.mkdir()
    write_r_csv(mdir / "points.csv", [ps[:, 0], ps[:, 1]], ["x", "y"], ["%.17g", "%.17g"])
    write_r_csv(mdir / "elements.csv", list((cs + 1).T), ["V1", "V2", "V3"], ["%d"] * 3)
    write_r_csv(mdir / "boundary.csv", [bs.astype(int)], ["b"], ["%d"])
    (p2, c2, b2), t_mesh = synced_seconds(lambda: load_mesh_csv(str(mdir)))
    mesh_equal = np.array_equal(p2, ps) and np.array_equal(c2, cs) and np.array_equal(b2.astype(bool), bs)
    S = assemble_matrix(FEMSpace(unit_square_mesh(32), 1), -fdt.laplacian(), device=DEVICE)
    mmwrite(str(scratch / "m.mtx"), S.to_scipy(), precision=17)
    dense_equal = np.array_equal(read_mtx(str(scratch / "m.mtx")), S.toarray())
    log(f"31d load_mesh_csv of the same mesh ({len(ps)} points, {len(cs)} elements): {t_mesh:.4f} s, "
        f"equal {mesh_equal}; read_mtx of unit_square_mesh(32)'s matrix == its dense form {dense_equal}")
    check(mesh_equal and dense_equal, "load_mesh_csv or read_mtx disagrees")
    return out, [u]


def phase_sanitize(solutions):
    """31e: assert_all_finite over the phase's solutions; checked on the
    card catches a NaN made in an intermediate and masked in the output, a
    NaN in a SparseMatrix's values, and an infinity that K2 makes (at the
    next torch operation, which reads it); it passes clean code."""
    from fdapde_core_tpu_torch.linear_algebra import SparseMatrix
    from fdapde_core_tpu_torch.utils.sanitize import assert_all_finite, checked

    assert_all_finite(solutions, "phase 31")

    def masked(x):
        for _ in range(3):
            y = torch.sqrt(x - 2.0)  # NaN in an intermediate
            x = torch.where(y == y, y, 1.0)  # masked in the output
        return x

    one = torch.ones(4, dtype=torch.float64, device=DEVICE)
    check(bool((masked(one) == 1.0).all()), "the masked function's output is not finite")
    A = SparseMatrix.from_dense(np.array([[1.0, 3.0], [0.0, 2.0]]), device=DEVICE)
    A_nan = A.with_vals(torch.tensor([1.0, float("nan"), 2.0], dtype=torch.float64, device=DEVICE))
    A_big = A.with_vals(torch.tensor([1e308, 1e308, 2.0], dtype=torch.float64, device=DEVICE))
    caught = []
    for what, fn, x in (("masked intermediate", masked, one),
                        ("NaN in a SparseMatrix's values", lambda v: (A_nan @ v).sum(), one[:2]),
                        ("inf made by K2, read by the next op", lambda v: (A_big @ v).sum(),
                         one[:2])):
        try:
            checked(fn)(x)
        except FloatingPointError as e:
            caught.append(f"{what}: {e}")
    clean = float(checked(lambda v: torch.sqrt(v).sum() + 1.0)(4 * one))
    log(f"31e assert_all_finite over {len(solutions)} solutions passed; checked caught "
        f"{caught}; a clean function gives {clean}")
    check(len(caught) == 3 and clean == 9.0, "checked missed a NaN or failed clean code")


def phase_slice11(ak, gs, ls, pts, cells, bnd, amg_run):
    """Phase 31: the slice's modules at full size. Returns {path: (K2, K6)}."""
    import shutil

    scratch = Path(__file__).resolve().parent / "fdapde_core_tpu_torch" / "_build" / "phase31"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    out, solutions = {}, []
    for run in (lambda: phase_network(ak, gs, ls, scratch), lambda: phase_interval(ak, gs, ls),
                lambda: phase_checkpoints(ak, gs, ls, pts, cells, bnd, amg_run, scratch),
                lambda: phase_io(ak, gs, ls, scratch)):
        (paths, xs), t = synced_seconds(run)
        log(f"31: {', '.join(paths)} in {t:.2f} s")
        out.update(paths)
        solutions += xs
        torch.cuda.empty_cache()
    phase_sanitize(solutions)
    shutil.rmtree(scratch)
    return out


# phase 32: the multi-device layer in a one-rank NCCL group. Solutions of
# earlier phases, kept on the host for phase 32's comparisons
TWINS = {}
N_SHARDED_P2 = 128  # RCM + HaloDIASolver on P2: 66,049 dofs, 1,035 offsets after RCM (CPU check)
N_HALO_ELL = 1024  # HaloELLSolver on irregular_mesh_device_soa(1024, 0.2): 1,050,625 dofs
PARA_STEPS, PARA_DT = 8, 1e-3  # HaloDIAParabolic on unit_square_mesh(N_DIA)


def kappa_p1(n):
    """4 n^2 / pi^2: the condition number of the P1 Laplacian with n cells a
    side. Two solves that each stop at rtol differ by at most 2 kappa rtol
    max|x| (each lies within kappa rtol |x| of the exact solution)."""
    return 4.0 * n * n / np.pi ** 2


def counted(ak, gs, fn):
    """fn() with every launch count zeroed just before; returns (out,
    seconds, {K1, K2, K6, K7, KC: launches}) read just after (KC's as the
    count's rise over fn, since main's totals by phase read it whole)."""
    from fdapde_core_tpu_torch.ops import dia_spmv as ds
    from fdapde_core_tpu_torch.ops import local_stiffness as ls

    from fdapde_core_tpu_torch.ops import grid_mg

    zero_launch_counts(ak, gs)
    kc = grid_mg.grid_coarse_cg_launches
    out, t = synced_seconds(fn)
    return out, t, {"K1": ak.p1_stencil_launches, "K2": gs.ell_spmv_launches,
                    "K6": ls.p1_stiffness_2d_launches, "K7": ds.dia_spmv_launches,
                    "KC": grid_mg.grid_coarse_cg_launches - kc}


def hold(name, x, twin, k, k_twin, tol, launches, t, rel=None):
    """A sharded solution against its single-device twin: max|x - twin| <=
    tol, iterations within 10 % (at least 1); logs and returns the row."""
    d = (x.detach().double().cpu() - twin.double().cpu()).abs().max().item()
    ks = list(k) if isinstance(k, (list, tuple)) else [k]
    kt = list(k_twin) if isinstance(k_twin, (list, tuple)) else [k_twin]
    log(f"32 {name}: {t:.4f} s, iterations {k} (single device {k_twin}), max|x - x_1dev| = "
        f"{d:.3e} (tol {tol:.3e})" + ("" if rel is None else f", true rel residual (f64) {rel:.3e}")
        + f"; launches {launches}")
    check(bool(torch.isfinite(x).all()), f"{name}: non-finite solution")
    check(d <= tol, f"{name}: max|x - x_1dev| = {d:.3e} > {tol:.3e}")
    check(all(abs(a - b) <= max(1, 0.1 * b) for a, b in zip(ks, kt)),
          f"{name}: iterations {k} against {k_twin} (not within 10 %)")
    return dict(seconds=t, iterations=k, twin_iterations=k_twin, max_diff=d, tol=tol, **launches)


def masked_rel_residual(A, mask, x, b_mod):
    """||b~ - A~ x|| / ||b~|| of the masked system through the plain f64
    product of a SparseMatrix."""
    free = (~mask).to(torch.float64)
    Ax = A.matmul_reference(x * free) * free + x * (~free.bool())
    return (torch.linalg.norm(b_mod - Ax) / torch.linalg.norm(b_mod)).item()


def nccl_costs(mesh, n_vec):
    """CUDA-event times of the three collectives in the one-rank group
    against a world of one without a group (no collective)."""
    from fdapde_core_tpu_torch.parallel import ShardMesh

    bare = ShardMesh(None, mesh.device)
    two = torch.zeros(2, dtype=torch.float64, device=DEVICE)
    vec = torch.zeros(n_vec, dtype=torch.float64, device=DEVICE)
    out = {}
    for name, fn in (("psum 2 f64", lambda m: m.psum(two)),
                     (f"psum {n_vec} f64", lambda m: m.psum(vec)),
                     (f"all_gather {n_vec} f64", lambda m: m.all_gather(vec))):
        out[name] = (time_ms(lambda: fn(mesh), 200), time_ms(lambda: fn(bare), 200))
    log("32 NCCL in a world of one (CUDA events, ms a call, group / no group): " + "; ".join(
        f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in out.items()))
    return {k: a for k, (a, _) in out.items()}


def halo_kernel_checks(gs, ds, dia_solver, ell_solver):
    """K7 on the halo-padded (K, block + 2H) table and K2 on the (K, block)
    table over the (block + 2H) halo-extended vector with the shard's warp
    widths, each against its plain version on the card (per-row bound K eps
    sum|a x|), K2 equal to its launch without the widths; both timed beside
    a torch.sparse CSR SpMV of the same entries (timed, never used)."""
    from fdapde_core_tpu_torch.linear_algebra import DIAMatrix

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
    eps = torch.finfo(torch.float64).eps
    out = {}
    D, offs = dia_solver.data, dia_solver._offsets_dev
    x = torch.rand(D.shape[1], generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    got, ref = ds.dia_spmv(D, offs, x), ds.dia_spmv_reference(D, offs, x)
    bound = D.shape[0] * eps * ds.dia_spmv_reference(D.abs(), offs, x.abs())
    err = (got - ref).abs()
    check(bool((err <= bound).all()), "K7 on the halo-padded table disagrees with its plain version")
    csr = csr_of(DIAMatrix(D, tuple(offs.tolist()), D.shape[1]).to_sparse())
    lib_err = (csr @ x - ref).abs().max().item()
    ms, plain_ms, lib_ms = (time_ms(lambda: ds.dia_spmv(D, offs, x), 50),
                            time_ms(lambda: ds.dia_spmv_reference(D, offs, x), 5),
                            time_ms(lambda: csr @ x, 50))
    del csr
    out["K7 halo"] = dict(table=tuple(D.shape), max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, library_err=lib_err,
                          **least_time(D.numel() * 8 + 2 * x.numel() * 8, 2 * D.numel(), torch.float64))
    V, C, W, H = ell_solver.vals, ell_solver.lcols, ell_solver.warp_w, ell_solver.H
    n_loc = V.shape[1]
    x = torch.rand(n_loc + 2 * H, generator=gen, dtype=torch.float64, device=DEVICE) - 0.5
    err, _ = k2_compact_check(gs, "the halo-extended table", V, C, x, W)
    # the shard's padding column is local row + H
    pad = torch.arange(n_loc, dtype=C.dtype, device=DEVICE) + H
    csr = ell_csr(V, C, pad, x.numel())
    lib_err = (csr @ x - gs.ell_spmv_reference(V, C, x)).abs().max().item()
    ms, full_ms, plain_ms, lib_ms = (time_ms(lambda: gs.ell_spmv(V, C, x, W), 50),
                                     time_ms(lambda: gs.ell_spmv(V, C, x), 50),
                                     time_ms(lambda: gs.ell_spmv_reference(V, C, x), 5),
                                     time_ms(lambda: csr @ x, 50))
    nnz = csr.values().numel()
    del csr
    out["K2 halo"] = dict(table=f"{tuple(V.shape)} over {x.numel()}", max_abs_err=err, ms=ms,
                          full_ms=full_ms, plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                          slots_per_entry=slots_read(gs, W, n_loc) / nnz,
                          full_slots_per_entry=V.numel() / nnz,
                          **least_time(nnz * 12 + (n_loc + x.numel()) * 8, 2 * nnz, torch.float64))
    for k, v in out.items():
        widths = ("" if "full_ms" not in v else
                  f" with the warp widths ({v['slots_per_entry']:.3f} slots read per entry), "
                  f"{v['full_ms']:.4f} ms without ({v['full_slots_per_entry']:.3f})")
        log(f"32 {k} {v['table']}: max|kernel - plain| {v['max_abs_err']:.3e} (within the per-row "
            f"bound), kernel {v['ms']:.4f} ms{widths}, torch.sparse CSR {v['library_ms']:.4f} ms "
            f"(max|csr-plain| {v['library_err']:.3e}), plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']})")
    return out


def sharded_poisson_paths(ak, gs, mesh, pts, cells, bnd):
    """ShardedPoisson on phase 12's mesh: segment and ell (Jacobi, against
    solve_elliptic's Jacobi CG at the same rtol) and the aux grid (against
    phase 12's PDE, rtol 1e-12)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import assemble_matrix, solve_elliptic
    from fdapde_core_tpu_torch.parallel import ShardedPoisson

    x12, k12, F = TWINS["general"]
    tri = fdt.Triangulation(pts, cells, bnd)
    F = F.to(DEVICE)
    g = torch.zeros_like(F)
    rows, twin = {}, None
    for name, rtol, opts in (("segment", 1e-10, {}), ("ell", 1e-10, {"spmv": "ell"}),
                             ("auxgrid", 1e-12, {"preconditioner": "auxgrid"})):
        sp = ShardedPoisson(tri, 1, mesh, **opts)
        if twin is None:  # the single-device Jacobi CG on the same system
            A = assemble_matrix(sp.space, -fdt.laplacian(), device=DEVICE)
            mask = torch.as_tensor(sp.space.boundary_dofs, device=DEVICE)
            (xj, info), t_twin = synced_seconds(lambda: solve_elliptic(A, F, mask, g, rtol=1e-10,
                                                                      maxiter=20000))
            twin = (xj.cpu(), info.iterations)
            log(f"32 single-device Jacobi CG at 1e-10 on phase 12's system: {info.iterations} "
                f"iterations in {t_twin:.4f} s")
        (x, res, k), t, launches = counted(ak, gs, lambda: sp.solve(F, g, rtol=rtol, maxiter=20000))
        ref, kref = (x12, k12) if name == "auxgrid" else twin
        rel = masked_rel_residual(A, mask, x, F * (~mask))
        rows[f"ShardedPoisson {name}"] = hold(
            f"ShardedPoisson {name} ({sp.n_dofs} dofs, rtol {rtol:g})", x, ref, k, kref,
            2 * kappa_p1(NX_PDE) * rtol * ref.abs().max().item(), launches, t, rel)
        # the true residual drifts from CG's recurrence one to the rounding
        # floor (4.7e-11 here, PERF.md section 2): held to 1e-10 as phase 12
        check(launches["K6"] >= 1 and rel <= max(10 * rtol, 1e-10),
              f"ShardedPoisson {name}: K6 launches / true residual {rel:.3e}")
    return rows


def dia_paths(ak, gs, mesh):
    """solve_elliptic_sharded (halo_dia) and HaloDIAParabolic on
    unit_square_mesh(N_DIA), HaloGridDIASolver on its grid; returns (rows,
    the HaloDIASolver for the kernel check)."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_dia, assemble_forcing, assemble_matrix
    from fdapde_core_tpu_torch.fem.solvers import solve_parabolic
    from fdapde_core_tpu_torch.geometry import unit_square_mesh
    from fdapde_core_tpu_torch.linear_algebra import prune_zero_offsets
    from fdapde_core_tpu_torch.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu_torch.models import solve_elliptic_sharded
    from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix
    from fdapde_core_tpu_torch.parallel import (HaloDIAParabolic, HaloDIASolver, HaloGridDIASolver,
                                                ShardMesh)

    x16, k16 = TWINS["dia"]
    rows = {}
    usm = unit_square_mesh(N_DIA)
    space = FEMSpace(usm, 1)
    q = space.quadrature_nodes
    f = 2 * np.pi ** 2 * np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1])
    (x, info), t, launches = counted(ak, gs, lambda: solve_elliptic_sharded(
        usm, -fdt.laplacian(), f, np.zeros(space.n_dofs), device_mesh=mesh, rtol=1e-8,
        maxiter=20000))
    check(info["strategy"] == "halo_dia", f"the driver took {info['strategy']}")
    rows["solve_elliptic_sharded"] = hold(
        f"solve_elliptic_sharded halo_dia ({info['n_dofs']} dofs, {info['n_offsets']} offsets, "
        f"rtol 1e-8)", x, x16, info["iterations"], k16, 2 * kappa_p1(N_DIA) * 1e-8 * x16.abs().max().item(),
        launches, t)
    check(launches["K7"] >= info["iterations"] and launches["K6"] >= 1, "driver: K7 / K6 launches")

    # the cost of the one-rank group: the same system through HaloDIASolver
    # with the group and with no group (no collective)
    D = prune_zero_offsets(assemble_dia(space, -fdt.laplacian(), device=DEVICE))
    mask = torch.as_tensor(space.boundary_dofs, device=DEVICE)
    free = (~mask).to(torch.float64)
    b_mod = assemble_forcing(space, f, device=DEVICE) * free
    per_it = {}
    for tag, m in (("NCCL group", mesh), ("no group", ShardMesh(None, mesh.device))):
        solver = HaloDIASolver(D, m)
        solver.solve(b_mod, free, rtol=1e-8, maxiter=50)  # warm
        (xw, _, kw), t = synced_seconds(lambda: solver.solve(b_mod, free, rtol=1e-8, maxiter=20000))
        per_it[tag] = (kw, t, 1e3 * t / kw)
    log("32 world of one, HaloDIASolver on the driver's system (K7, Jacobi, 1e-8): " + "; ".join(
        f"{tag} {kw} iterations in {t:.4f} s ({ms:.4f} ms an iteration)"
        for tag, (kw, t, ms) in per_it.items()))
    rows["world of one"] = dict(group_ms_per_iteration=per_it["NCCL group"][2],
                                no_group_ms_per_iteration=per_it["no group"][2])
    check(per_it["NCCL group"][0] == per_it["no group"][0], "the group changed the iterations")

    # the grid form of the same system (Jacobi CG, rtol 1e-8), against phase 16
    G = GridDIAMatrix.from_dia(D, (N_DIA + 1, N_DIA + 1))
    solver = HaloGridDIASolver(G, free, mesh)
    (xg, _, kg), t, launches = counted(ak, gs, lambda: solver.solve(b_mod, rtol=1e-8, maxiter=20000))
    rows["HaloGridDIASolver"] = hold(f"HaloGridDIASolver n={N_DIA} (rtol 1e-8)", xg, x16, kg, k16,
                                     2 * kappa_p1(N_DIA) * 1e-8 * x16.abs().max().item(), launches, t)
    del G, solver

    # implicit Euler, 8 steps from sin(pi x) sin(pi y), against solve_parabolic
    A = assemble_matrix(space, -fdt.laplacian(), device=DEVICE)
    M = assemble_matrix(space, fdt.reaction(1.0), device=DEVICE)
    rows_, cols_, _ = space.scatter
    offs = unique_offsets(space.dofs)
    Ad = dia_from_coo(rows_, cols_, A.vals, space.n_dofs, offs)
    Md = dia_from_coo(rows_, cols_, M.vals, space.n_dofs, offs)
    c = torch.as_tensor(space.dof_coords, device=DEVICE)
    u0 = torch.sin(np.pi * c[:, 0]) * torch.sin(np.pi * c[:, 1])
    times = np.arange(PARA_STEPS + 1) * PARA_DT
    zeros = torch.zeros((space.n_dofs, PARA_STEPS + 1), dtype=torch.float64, device=DEVICE)
    (U, pinfo), t_twin = synced_seconds(lambda: solve_parabolic(
        A, M, zeros, mask, zeros, u0, times, rtol=1e-10, return_info=True))
    para = HaloDIAParabolic(Ad, Md, PARA_DT, mesh)
    us, t, launches = counted(ak, gs, lambda: para.solve(zeros[:, 1:], zeros[:, 1:], u0, free,
                                                         rtol=1e-10))
    log(f"32 solve_parabolic twin: {t_twin:.4f} s, steps' iterations {pinfo['iterations'].tolist()}")
    # each step's error is within kappa(K) rtol, K = M/dt + A far better
    # conditioned than A; hold the trajectory to 2 kappa(A) rtol, an upper bound
    rows["HaloDIAParabolic"] = hold(
        f"HaloDIAParabolic {PARA_STEPS} steps dt {PARA_DT:g} (rtol 1e-10)", us, U[:, 1:].cpu(),
        para.step_iterations, pinfo["iterations"].tolist(),
        2 * kappa_p1(N_DIA) * 1e-10 * U.abs().max().item(), launches, t)
    check(launches["K7"] > 0, "HaloDIAParabolic never launched K7")
    return rows, HaloDIASolver(D, mesh)


def rcm_p2_path(ak, gs, mesh):
    """P2 on unit_square_mesh(N_SHARDED_P2): RCM, then HaloDIASolver against
    solve_elliptic on the unpermuted system."""
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.fem import FEMSpace, assemble_forcing, assemble_matrix, solve_elliptic
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.geometry import unit_square_mesh
    from fdapde_core_tpu_torch.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu_torch.parallel import HaloDIASolver
    from fdapde_core_tpu_torch.parallel.reorder import permute_system, rcm_permutation

    space = FEMSpace(unit_square_mesh(N_SHARDED_P2), 2)
    n = space.n_dofs
    A = assemble_matrix(space, -fdt.laplacian(), device=DEVICE)
    F = assemble_forcing(space, lambda p: 4.0, device=DEVICE)
    xy = torch.as_tensor(space.dof_coords, device=DEVICE)
    g = 1 - xy[:, 0] ** 2 - xy[:, 1] ** 2
    mask = torch.as_tensor(space.boundary_dofs, device=DEVICE)
    (xt, info), t_twin = synced_seconds(lambda: solve_elliptic(A, F, mask, g, rtol=1e-10,
                                                               maxiter=20000))
    rows_, cols_, _ = space.scatter
    (perm, inv), t_rcm = synced_seconds(lambda: rcm_permutation(rows_, cols_, n))
    o_raw, offs = unique_offsets(space.dofs), unique_offsets(inv[space.dofs])
    log(f"32 RCM on P2 unit_square_mesh({N_SHARDED_P2}) ({n} dofs) in {t_rcm:.4f} s: K {len(o_raw)} "
        f"-> {len(offs)} offsets, H {max(map(abs, o_raw))} -> {max(map(abs, offs))}; single-device "
        f"Jacobi CG {info.iterations} iterations in {t_twin:.4f} s")
    rp, cp = permute_system(perm, inv, rows_, cols_)
    D = dia_from_coo(rp, cp, A.vals, n, offs)
    b_mod = DirichletSystem(A, mask).rhs(F, g)
    pt = torch.as_tensor(perm, device=DEVICE)
    solver = HaloDIASolver(D, mesh)
    (xp, _, k), t, launches = counted(ak, gs, lambda: solver.solve(
        b_mod[pt], (~mask).to(torch.float64)[pt], rtol=1e-10, maxiter=20000))
    x = xp[torch.as_tensor(inv, device=DEVICE)]
    return {"RCM P2 HaloDIASolver": hold(
        f"RCM P2 HaloDIASolver ({len(offs)} x {n} DIA, rtol 1e-10)", x, xt.cpu(), k, info.iterations,
        2 * kappa_p1(2 * N_SHARDED_P2) * 1e-10 * xt.abs().max().item(), launches, t)}


def structured_mg_path(ak, gs, mesh):
    """ShardedGridMG on the n = N_MAIN operator from K1 (as phase 4), f64,
    against phase 4's MG-CG."""
    from fdapde_core_tpu_torch.models import StructuredPoisson
    from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix
    from fdapde_core_tpu_torch.parallel.mg import ShardedGridMG

    x4, k4 = TWINS["structured"]

    def run():
        model = StructuredPoisson(N_MAIN, dtype=torch.float32, device=DEVICE)
        G = model.operator()
        smg = ShardedGridMG(GridDIAMatrix(G.data.double(), G.offsets2d, G.shape2d), mesh)
        return smg, smg.solve(model.rhs().double(), rtol=1e-9, maxiter=60)

    (smg, (x, rel, k)), t, launches = counted(ak, gs, run)
    check(k <= 15 and rel.item() <= 1e-9 and launches["K1"] >= 1,
          f"ShardedGridMG: {k} iterations, rel {rel.item():.3e}, K1 {launches['K1']}")
    log(f"32 ShardedGridMG levels {smg.shapes}, sharded {smg.T} ({smg.blocks} rows), tail "
        f"{smg.tail.shapes}")
    return {"ShardedGridMG": hold(f"ShardedGridMG n={N_MAIN} ({x.numel()} dofs, rtol 1e-9)", x, x4,
                                  k, k4, 2 * kappa_p1(N_MAIN) * 1e-9 * x4.abs().max().item(),
                                  launches, t)}


def halo_ell_path(ak, gs, mesh):
    """HaloELLSolver on irregular_mesh_device_soa(N_HALO_ELL) f64 against the
    single-device Jacobi CG on K2; returns (rows, the solver)."""
    from fdapde_core_tpu_torch.fem.solvers import DirichletSystem
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device_soa
    from fdapde_core_tpu_torch.linear_algebra import cg, jacobi_preconditioner
    from fdapde_core_tpu_torch.ops.matfree_soa import MatrixFreeSoA
    from fdapde_core_tpu_torch.parallel import HaloELLSolver

    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(N_HALO_ELL, 0.2, dtype=torch.float64,
                                                      device=DEVICE)
    op, _ = MatrixFreeSoA.build(x, y, c0, c1, c2, x.shape[0], 8)
    E, _ = op.to_ell(9)
    del op
    b = torch.where(bnd, 0.0, 1.0).to(torch.float64) / N_HALO_ELL ** 2
    sys_ = DirichletSystem(E, bnd)
    (xt, info), t_twin = synced_seconds(lambda: cg(sys_, b, M_inv=jacobi_preconditioner(
        sys_.diagonal()), rtol=1e-8, maxiter=20000))
    log(f"32 single-device Jacobi CG on K2 ({E.vals.shape}): {info.iterations} iterations in "
        f"{t_twin:.4f} s")
    solver = HaloELLSolver(E, mesh)
    (xs, _, k), t, launches = counted(ak, gs, lambda: solver.solve(b, (~bnd).to(torch.float64),
                                                                   rtol=1e-8, maxiter=20000))
    check(launches["K2"] >= k, "HaloELLSolver: K2 launches")
    check(k == ITERATIONS_KEPT["HaloELLSolver"], f"HaloELLSolver took {k} iterations, not "
                                                 f"{ITERATIONS_KEPT['HaloELLSolver']}")
    return {"HaloELLSolver": hold(f"HaloELLSolver n={N_HALO_ELL} (H {solver.H}, rtol 1e-8)", xs,
                                  xt.cpu(), k, info.iterations,
                                  2 * kappa_p1(N_HALO_ELL) * 1e-8 * xt.abs().max().item(),
                                  launches, t)}, solver


def banded_mg_path(ak, gs, mesh):
    """ShardedBandedMGSolver on gen10m's folded split against phase 22."""
    from fdapde_core_tpu_torch.geometry import irregular_mesh_device
    from fdapde_core_tpu_torch.models import MatrixFreePoisson
    from fdapde_core_tpu_torch.parallel.banded import ShardedBandedMGSolver

    x22, k22 = TWINS["gen10m"]
    nodes, cells, bnd = irregular_mesh_device(N_MAIN, 0.2, dtype=torch.float64, device=DEVICE)
    model = MatrixFreePoisson(nodes, cells, bnd, device=DEVICE)
    check(model.preconditioner == "banded_mg" and model.op.rem is None, "gen10m: no clean split")
    F = model.op.fold_dirichlet(bnd)
    b = torch.where(bnd, 0.0, model.load_vector(torch.ones(cells.shape[0], dtype=torch.float64,
                                                          device=DEVICE)))
    del model
    solver = ShardedBandedMGSolver(F, mesh)
    (x, rel, k), t, launches = counted(ak, gs, lambda: solver.solve(b, rtol=1e-9, maxiter=60))
    check(rel.item() <= 1e-9, "ShardedBandedMGSolver did not reach 1e-9")
    return {"ShardedBandedMGSolver": hold(
        f"ShardedBandedMGSolver gen10m n={N_MAIN} (grid {F.G.shape2d} -> {solver.m}^2, rtol 1e-9)",
        x, x22, k, k22, 2 * kappa_p1(N_MAIN) * 1e-9 * x22.abs().max().item(), launches, t)}


def halo_lane_path(ak, gs, mesh):
    """HaloLaneSolver with the distributed aux grid on genscat against phase
    8's lane solve: inner iterations within 2x + 2 (JAX's bound)."""
    from fdapde_core_tpu_torch.models import MatrixFreeElliptic
    from fdapde_core_tpu_torch.parallel import HaloLaneSolver

    xs8, its8 = TWINS["genscat"]
    x, y, cells, bnd = scrambled_mesh(N_MAIN, *SCRAMBLE)
    model = MatrixFreeElliptic((x, y), cells, bnd, K=1.0, gather_kernel="lane", device=DEVICE)
    b = torch.where(bnd, 0.0, model.load_vector(torch.ones(cells.shape[0], dtype=torch.float64,
                                                           device=DEVICE)))
    E, aux = model.op_ref, model.aux
    del model
    solver = HaloLaneSolver(E, mesh, aux=aux)
    (xs, res, k), t, launches = counted(ak, gs, lambda: solver.solve(
        b, (~bnd).to(torch.float64), rtol=1e-8, maxiter=400))
    check(solver.n_remainder == 0 and k <= 2 * its8 + 2 and launches["K2"] >= 3 * k,
          f"HaloLaneSolver: {k} iterations against phase 8's {its8} inner ones")
    rel = (res / torch.linalg.norm(b)).item()
    d = (xs.cpu() - xs8).abs().max().item()
    tol = 2 * kappa_p1(N_MAIN) * 1e-8 * xs8.abs().max().item()
    log(f"32 HaloLaneSolver genscat n={N_MAIN} (H {solver.H}, aux grid {aux.n_grid}, {aux.mg.shapes}): "
        f"{t:.4f} s, {k} iterations (phase 8's lane solve {its8} inner), rel residual {rel:.3e}, "
        f"max|x - x_phase8| = {d:.3e} (tol {tol:.3e}); launches {launches}")
    check(rel <= 1e-8 and d <= tol, "HaloLaneSolver: residual / solution")
    return {"HaloLaneSolver": dict(seconds=t, iterations=k, twin_iterations=its8, max_diff=d,
                                   tol=tol, **launches)}


def space_time_paths(ak, gs, mesh):
    """ShardedSpaceTime on phase 19's fit operator (against its fit) and
    solve_space_time_fdm(device_mesh=) on its pencil (against the
    single-device FDM)."""
    from fdapde_core_tpu_torch.models import solve_space_time_fdm
    from fdapde_core_tpu_torch.parallel import ShardedSpaceTime

    st = TWINS.pop("space_time")
    model, b = st["model"], st["b"]
    rows = {}
    solver = ShardedSpaceTime(model._op.terms, mesh)
    (x, res, k), t, launches = counted(ak, gs, lambda: solver.solve(b, rtol=1e-10, maxiter=20000))
    C = st["C"].reshape(-1)
    d = (x.cpu() - C).abs().max().item()
    log(f"32 ShardedSpaceTime fit operator ({solver.n_t} x {solver.n_s}, H {solver.H}, rtol 1e-10 "
        f"on r.z): {t:.4f} s, {k} iterations (the fit's CG {st['its']} on ||r||), "
        f"max|x - fit| = {d:.3e}; launches {launches}")
    rows["ShardedSpaceTime"] = dict(seconds=t, iterations=k, twin_iterations=st["its"], max_diff=d,
                                    **launches)
    check(bool(torch.isfinite(x).all()) and launches["K2"] > 0, "ShardedSpaceTime")
    check(d <= 1e-6 * C.abs().max().item(), "ShardedSpaceTime against the fit")
    check(abs(k - st["its"]) <= max(1, 0.1 * st["its"]),
          f"ShardedSpaceTime: {k} iterations against the fit's {st['its']} (not within 10 %)")
    (xf, info), t, launches = counted(ak, gs, lambda: solve_space_time_fdm(
        model.Mt, st["T1"], model.Ms, st["S1"], b, rtol=1e-12, maxiter=20000,
        device_mesh=mesh))
    # the same mode solves on the same card, gathered by a copy: bitwise
    rows["FDM device_mesh"] = hold("solve_space_time_fdm(device_mesh=) (27 modes, rtol 1e-12)", xf,
                                   st["x_fdm"], info.iterations, st["its_fdm"], 0.0, launches, t)
    return rows


def phase_sharded(ak, gs, ds, pts, cells, bnd):
    """Phase 32: every sharded path at full size in a one-rank NCCL group;
    returns ({path: row}, kernel checks, NCCL costs)."""
    from fdapde_core_tpu_torch.parallel import close_world, init_world
    from fdapde_core_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh = init_world(DEVICE, rank=0, world_size=1)
    try:
        log(f"32 world: {mesh}, backend nccl; N > 1 on one card (gloo over CUDA tensors) not attempted")
        costs = nccl_costs(mesh, (NX_PDE + 1) ** 2)
        rows = {}
        rows.update(sharded_poisson_paths(ak, gs, mesh, pts, cells, bnd))
        torch.cuda.empty_cache()
        dia_rows, dia_solver = dia_paths(ak, gs, mesh)
        rows.update(dia_rows)
        rows.update(rcm_p2_path(ak, gs, mesh))
        torch.cuda.empty_cache()
        rows.update(structured_mg_path(ak, gs, mesh))
        torch.cuda.empty_cache()
        ell_rows, ell_solver = halo_ell_path(ak, gs, mesh)
        rows.update(ell_rows)
        kernels = halo_kernel_checks(gs, ds, dia_solver, ell_solver)
        del dia_solver, ell_solver
        torch.cuda.empty_cache()
        rows.update(banded_mg_path(ak, gs, mesh))
        torch.cuda.empty_cache()
        rows.update(halo_lane_path(ak, gs, mesh))
        torch.cuda.empty_cache()
        rows.update(space_time_paths(ak, gs, mesh))
        done, t, launches = counted(ak, gs, lambda: dryrun_multichip(mesh))
        log(f"32 dryrun_multichip at N = 1: {len(done)} paths in {t:.4f} s, max|diff| by path "
            + ", ".join(f"{k} {d:.1e} (rtol {r:g})" for k, (d, r) in done.items())
            + f"; launches {launches}")
        check(len(done) == 12, f"the dry run ran {len(done)} of 12 paths")
        rows["dryrun_multichip"] = dict(seconds=t, **launches)
    finally:
        close_world()
    return rows, kernels, costs


def timed_phase(number, fn, runs_grid_mg=False):
    """Run a phase, its V-cycle coarse solves counted (``coarse_counted``),
    print its seconds, return its result."""
    out, t = synced_seconds(lambda: coarse_counted(number, fn, runs_grid_mg))
    log(f"phase {number}: {t:.2f} s")
    return out


# phase -> (KC launches, coarse solves of card vectors that took the plain loop)
COARSE_BY_PHASE = {}
LEVEL_BY_PHASE = {}  # phase -> stage-kernel launches on the finer levels
PLAIN_COARSE_ON_CARD = [0]
COARSE_FAULTS = []  # checked once every phase has run, so one run names them all


def count_plain_coarse_solves(grid_mg):
    """Count the V-cycle coarse solves of card vectors that take the plain
    loop (``grid_mg._coarse_cg``, which ``GridMG._coarse_solve`` calls where
    KC does not apply) from here on; returns the plain loop itself."""
    plain = grid_mg._coarse_cg

    def counting(data, offsets2d, m, b, n_iter):
        PLAIN_COARSE_ON_CARD[0] += b.is_cuda
        return plain(data, offsets2d, m, b, n_iter)

    grid_mg._coarse_cg = counting
    return plain


def coarse_counted(phase, fn, runs_grid_mg=False):
    """fn() with its V-cycle coarse solves counted by phase: KC's launches
    and the card's solves on the plain loop. A phase that runs a 2D GridMG
    on the card (``runs_grid_mg``) must launch KC and take the plain loop
    for none of them; main checks that after the last phase."""
    from fdapde_core_tpu_torch.ops import grid_mg

    kc, plain = grid_mg.grid_coarse_cg_launches, PLAIN_COARSE_ON_CARD[0]
    levels = grid_mg.grid_mg_level_launches
    out = fn()
    kc, plain = grid_mg.grid_coarse_cg_launches - kc, PLAIN_COARSE_ON_CARD[0] - plain
    COARSE_BY_PHASE[phase] = (kc, plain)
    LEVEL_BY_PHASE[phase] = grid_mg.grid_mg_level_launches - levels
    log(f"phase {phase}: KC launches {kc}, card coarse solves on the plain loop {plain}, "
        f"stage-kernel launches {LEVEL_BY_PHASE[phase]}")
    if runs_grid_mg and kc == 0:
        COARSE_FAULTS.append(f"phase {phase} runs a 2D GridMG on the card but never launched KC")
    if runs_grid_mg and plain:
        COARSE_FAULTS.append(f"phase {phase}: {plain} card coarse solves took the plain loop")
    return out


def kc_bound_ms(dtype, K, m, n_iter):
    """KC's least time from latency, not bytes or operations (one block on
    one SM; its bytes take 0.06 us at 3.35 TB/s): n_iter times the
    dependent chain of one CG iteration, in assumed cycle counts (rounded
    low) at the H100 SXM's 1,980 MHz boost clock: an L1 read of the layers,
    the stencil's K ordered adds, the thread's P-point partial of p.Ap, two
    block sums (5 shuffle-adds, a shared store, a barrier, a shared load, 5
    shuffle-adds), two divisions, the P-point partial of r.r, and p's
    update, store and barrier. P: the points a thread owns."""
    shfl, smem, barrier, l1 = 20, 20, 20, 30
    add, div = {torch.float32: (4, 20), torch.float64: (8, 40)}[dtype]
    P = -(-m * m // KC_THREADS)
    block_sum = 10 * (shfl + add) + smem + barrier + smem
    chain = l1 + K * add + P * add + 2 * block_sum + 2 * div + P * add + 2 * add + smem + barrier
    return n_iter * chain / 1.98e9 * 1e3


def phase_coarse_cg(grid_mg, plain_coarse_cg, StructuredPoisson):
    """Phase 33: KC, the V-cycle's coarse solve in one launch, against the
    plain loop on the main path's coarsest level (StructuredPoisson(N_MAIN,
    float32): m = 51, K = 9), float32 and float64 vectors; returns the
    float32 measurements with the float64 ones under "float64"."""
    grid_mg.grid_coarse_cg_launches = 0
    mg = StructuredPoisson(N_MAIN, dtype=torch.float32, device=DEVICE).multigrid()
    data, offs, m, n_iter = mg.datas[-1], mg.offsets[-1], mg.shapes[-1], mg.coarse_iters
    check((m, len(offs), n_iter) == (51, 9, 64),
          f"coarsest level m={m}, K={len(offs)}, {n_iter} iterations")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 33)
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        layers = mg._coarse_layers(dtype)
        b = torch.randn((m, m), generator=gen, dtype=torch.float64, device=DEVICE).to(dtype)
        kernel = lambda: grid_mg.grid_coarse_cg(layers, offs, b, n_iter)  # noqa: E731
        plain = lambda: plain_coarse_cg(data, offs, m, b, n_iter)  # noqa: E731
        got, want = kernel(), plain()
        gap = ((got - want).norm() / want.norm()).item()
        want1 = plain_coarse_cg(data, offs, m, b, 1)
        one = ((grid_mg.grid_coarse_cg(layers, offs, b, 1) - want1).norm() / want1.norm()).item()
        zero = grid_mg.grid_coarse_cg(layers, offs, torch.zeros_like(b), n_iter)
        log(f"KC m={m} K={len(offs)} {dtype}: relative gap to the plain loop {gap:.3e} after "
            f"{n_iter} it., {one:.3e} after 1 (tol {tol:g})")
        check(gap <= tol and one <= tol, f"KC {dtype} disagrees with the plain loop")
        check(torch.equal(got, kernel()), f"KC {dtype} is not bitwise stable from run to run")
        check(not zero.any(), f"KC {dtype}: a zero right-hand side gave a nonzero x")
        k1, p1 = time_ms(kernel, 200), time_ms(plain, 5)
        k2, p2 = time_ms(kernel, 200), time_ms(plain, 5)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound = kc_bound_ms(dtype, len(offs), m, n_iter)
        log(f"KC m={m} {dtype}: kernel {k1:.4f} / {k2:.4f} ms ({1e3 * ms / n_iter:.2f} us an "
            f"iteration), plain loop {p1:.4f} / {p2:.4f} ms; bound {bound:.4f} ms (latency, "
            f"{100 * bound / ms:.0f} %)")
        out[str(dtype).split(".")[-1]] = dict(max_rel_err=gap, ms=ms, plain_ms=plain_ms,
                                             library_ms=None, bound_ms=bound, bound_by="latency")
    check(grid_mg.grid_coarse_cg_launches > 0, "KC's launch count did not rise")
    return dict(out["float32"], float64=out["float64"])


# the stage kernels' timing shapes: (name, m, K, layer and vector dtype)
LEVEL_SHAPES = (("aux level 0", 3201, 5, torch.float32), ("banded level 0", 3201, 9, torch.float32),
                ("level 1", 1601, 9, torch.float32), ("pde aux level 0", 721, 5, torch.float64))


def level_layers(m, K, dtype, gen):
    """(K, m, m) layers of a diagonally dominant stencil with variable
    coefficients: K = 5 the 5-point offsets, K = 9 the 9-point window."""
    from fdapde_core_tpu_torch.ops.grid_mg import _NINE_POINT

    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)) if K == 5 else _NINE_POINT
    lay = -0.25 * torch.rand((K, m, m), generator=gen, dtype=dtype, device=DEVICE)
    lay[offsets.index((0, 0))] = 2.0 + torch.rand((m, m), generator=gen, dtype=dtype,
                                                  device=DEVICE)
    return lay, offsets


def host_us(fn, n):
    """Host microseconds a call of fn, enqueued n times without a wait."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def phase_level_kernels(grid_mg):
    """Phase 34: the finer levels' stage kernels at the main paths' level
    shapes against their bytes bound and the plain stages, each stage and
    a V-cycle held bitwise to the plain ones; returns the measurements by
    shape, the wrappers' host us a launch and the launches they made."""
    from fdapde_core_tpu_torch.ops.grid_dia import GridDIAMatrix
    from fdapde_core_tpu_torch.ops.grid_mg import GridMG, LevelKernels

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 34)
    stream = torch.cuda.current_stream().cuda_stream
    launches0 = grid_mg.grid_mg_level_launches
    bits = lambda t: t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)  # noqa: E731
    out = {}
    for name, m, K, dtype in LEVEL_SHAPES:
        layers, offsets = level_layers(m, K, dtype, gen)
        mc, size = (m + 1) // 2, torch.finfo(dtype).bits // 8
        n, nc = m * m, mc * mc
        ops = LevelKernels(layers, offsets, dtype)
        plain = GridMG([layers], (offsets,), (m,), 0.8, 1, 64)
        b = torch.randn((m, m), generator=gen, dtype=dtype, device=DEVICE)
        x = torch.randn((m, m), generator=gen, dtype=dtype, device=DEVICE)
        e = torch.randn((mc, mc), generator=gen, dtype=dtype, device=DEVICE)
        xp = x.clone()  # the prolongation's in-place target
        stages = {  # name: (kernel, plain, bytes)
            "sweep": (lambda: ops.smooth(b, x, 0.8, 1, stream), lambda: plain._smooth(0, x, b),
                      n * (K + 3) * size),
            "sweep_from_zero": (lambda: ops.smooth(b, None, 0.8, 1, stream),
                                lambda: plain._smooth(0, torch.zeros_like(b), b), n * 3 * size),
            "residual": (lambda: ops.residual(b, x, stream),
                         lambda: b - grid_mg._stencil(layers, offsets, x, m), n * (K + 3) * size),
            "restrict": (lambda: ops.restrict(x, stream), lambda: grid_mg._restrict(x, mc),
                         (n + nc) * size),
            "prolong": (lambda: ops.prolong_add(e, xp, stream),
                        lambda: x + grid_mg._prolong(e, m), (2 * n + nc) * size),
        }
        row = {}
        for stage, (kernel, plain_fn, nbytes) in stages.items():
            before = grid_mg.grid_mg_level_launches
            got = kernel()
            check(grid_mg.grid_mg_level_launches == before + 1,
                  f"{name} {stage}: {grid_mg.grid_mg_level_launches - before} launches")
            check(torch.equal(bits(got), bits(plain_fn())), f"{name} {stage}: not bitwise the plain")
            ms, plain_ms = time_ms(kernel, 50), time_ms(plain_fn, 5)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            row[stage] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                              launches=1)
            log(f"stage kernels {name} (m={m}, K={K}, {dtype}) {stage}: {ms:.4f} ms, bound "
                f"{bound:.4f} ms ({100 * bound / ms:.0f} %), plain {plain_ms:.4f} ms, 1 launch, "
                f"bitwise the plain stage")
        mg = GridMG.build(GridDIAMatrix(layers, offsets, (m, m)))
        r = torch.randn(n, generator=gen, dtype=dtype, device=DEVICE)
        before = grid_mg.grid_mg_level_launches
        got = mg.v_cycle(r)
        per_level = (grid_mg.grid_mg_level_launches - before) / (mg.n_levels - 1)
        apply = grid_mg.level_kernels_apply
        grid_mg.level_kernels_apply = lambda *a: False
        try:
            want = mg.v_cycle(r)
            plain_vc = time_ms(lambda: mg.v_cycle(r), 3)
        finally:
            grid_mg.level_kernels_apply = apply
        check(torch.equal(bits(got), bits(want)), f"{name}: the V-cycle is not bitwise the plain")
        check(per_level <= 8, f"{name}: {per_level} launches a finer level")
        vc = time_ms(lambda: mg.v_cycle(r), 20)
        vc_host = host_us(lambda: mg.v_cycle(r), 20) / 1e3
        log(f"stage kernels {name}: V-cycle on levels {mg.shapes} bitwise the plain one, "
            f"{per_level:.0f} launches a finer level; {vc:.4f} ms on the card ({vc_host:.4f} host "
            f"ms to enqueue), plain {plain_vc:.4f} ms")
        out[name] = dict(m=m, K=K, dtype=str(dtype), stages=row, vcycle_ms=vc,
                         vcycle_host_ms=vc_host, vcycle_plain_ms=plain_vc,
                         vcycle_levels=list(mg.shapes), launches_per_level=per_level)
        del layers, ops, plain, mg, b, x, xp, e, r, got, want
        torch.cuda.empty_cache()
    # the wrappers' host cost a launch, where the card outruns the host
    layers, offsets = level_layers(51, 9, torch.float32, gen)
    ops = LevelKernels(layers, offsets, torch.float32)
    b = torch.randn((51, 51), generator=gen, device=DEVICE)
    x = torch.randn((51, 51), generator=gen, device=DEVICE)
    r = torch.empty_like(b)
    lib_args = (*ops._lay, b.data_ptr(), x.data_ptr(), r.data_ptr(), *ops._grid, stream)
    wrapper = dict(
        residual_us=host_us(lambda: ops.residual(b, x, stream), 4000),
        smooth_nu2_us_a_launch=host_us(lambda: ops.smooth(b, None, 0.8, 2, stream), 2000) / 2,
        c_call_us=host_us(lambda: ops._residual(*lib_args), 4000),
        current_stream_us=host_us(lambda: torch.cuda.current_stream().cuda_stream, 4000))
    log("stage kernels: host us a launch: " + ", ".join(f"{k} {v:.2f}" for k, v in wrapper.items()))
    check(grid_mg.grid_mg_level_launches > launches0, "the stage kernels' launch count did not rise")
    return dict(shapes=out, host_us=wrapper, launches=grid_mg.grid_mg_level_launches - launches0)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fdapde_core_tpu_torch import _build
    from fdapde_core_tpu_torch.models import StructuredPoisson
    from fdapde_core_tpu_torch.ops import assembly_kernels as ak
    from fdapde_core_tpu_torch.ops import dia_spmv as ds
    from fdapde_core_tpu_torch.ops import gather_spmv as gs
    from fdapde_core_tpu_torch.ops import grid_mg
    from fdapde_core_tpu_torch.ops import local_stiffness as ls
    from fdapde_core_tpu_torch.ops.grid_assembly import stencil_from_coords
    from fdapde_core_tpu_torch.ops.grid_cg import grid_cg

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)

    _, t_build = synced_seconds(_build.library)
    log(f"kernel build {t_build:.2f} s")
    for line in _build.build_log().splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")

    k1 = phase_kernel_vs_plain(ak)
    plain_coarse_cg = count_plain_coarse_solves(grid_mg)
    model, launches = coarse_counted(4, lambda: phase_main_path(ak, gs, StructuredPoisson), True)
    coarse_counted(5, lambda: phase_harmonic(StructuredPoisson), True)
    phase_jacobi(model, grid_cg)
    del model
    torch.cuda.empty_cache()

    k2, k2_mixed = phase_k2_vs_plain(gs)
    gs.ell_spmv_widened_launches = 0  # from here on, the paths' own
    torch.cuda.empty_cache()
    k2_launches = coarse_counted(8, lambda: phase_general_main_path(ak, gs), True)
    torch.cuda.empty_cache()
    coarse_counted(9, lambda: phase_matfree_poisson(ak, gs), True)
    torch.cuda.empty_cache()
    coarse_counted(10, phase_general_harmonic, True)
    torch.cuda.empty_cache()

    (pts, cells, bnd), t_mesh = synced_seconds(lambda: delaunay_mesh(NX_PDE))
    k456 = phase_local_stiffness(ak, gs, ls, pts, cells)
    torch.cuda.empty_cache()
    pde, k6_launches, aux_run = coarse_counted(
        12, lambda: phase_pde_main_path(ak, gs, ls, pts, cells, bnd, t_mesh), True)
    coarse_counted(13, lambda: phase_pde_harmonic(pde))
    mesh = pde.domain
    del pde
    torch.cuda.empty_cache()
    new_paths = {}  # phases 20-31: {path: (K2 launches, K6 launches)}
    new_paths.update(timed_phase(20, lambda: phase_parabolic(ak, gs, ls, mesh)))
    paths_21, amg_run = timed_phase(21, lambda: phase_amg(ak, gs, ls, mesh, aux_run))
    new_paths.update(paths_21)
    del aux_run
    torch.cuda.empty_cache()
    obs = phase_point_location(mesh)
    torch.cuda.empty_cache()
    k2_reg, k6_reg, k2_sliced = phase_regression(ak, gs, ls, mesh, obs)
    del mesh, obs
    torch.cuda.empty_cache()
    k2_st, k6_st = coarse_counted(19, lambda: phase_space_time(ak, gs, ls))
    torch.cuda.empty_cache()
    log(f"K2 launches by path: lane solve {k2_launches}, regression {k2_reg}, space-time {k2_st}; "
        f"K6: PDE init {k6_launches}, regression {k6_reg}, space-time {k6_st}")
    k2_launches += k2_reg + k2_st
    k6_launches += k6_reg + k6_st

    k3 = phase_k3(ak, gs)
    torch.cuda.empty_cache()
    D, k7_launches = coarse_counted(16, lambda: phase_dia_main_path(ak, gs, ds, ls))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    G = stencil_from_coords(*perturbed_planes(N_MAIN, torch.float32, gen), N_MAIN)
    k7 = phase_k7(ds, [("DIA path", D, None),
                       (f"flattened n={N_MAIN} stencil", flat_stencil_dia(G), G.__matmul__)])
    del D, G
    torch.cuda.empty_cache()

    lattice, k2_banded = timed_phase(22, lambda: phase_banded(ak, gs), True)
    new_paths.update({path: (k2, 0) for path, k2 in k2_banded.items()})
    torch.cuda.empty_cache()
    new_paths.update(timed_phase(23, lambda: phase_matfree_parabolic(ak, gs, ls, lattice)))
    del lattice
    torch.cuda.empty_cache()
    k2_p2, space2, compact_p2 = timed_phase(24, lambda: phase_p2(ak, gs, pts, cells, bnd))
    new_paths.update({path: (k2, 0) for path, k2 in k2_p2.items()})
    torch.cuda.empty_cache()
    k2_gendel, compact_gendel = timed_phase(25, lambda: phase_lane_aux(ak, gs))
    new_paths.update({path: (k2, 0) for path, k2 in k2_gendel.items()})
    torch.cuda.empty_cache()
    mesh3d, k2_gen3d, tables_gen3d = timed_phase(26, lambda: phase_gen3d(ak, gs))
    new_paths.update({path: (k2, 0) for path, k2 in k2_gen3d.items()})
    torch.cuda.empty_cache()
    k2_aux3d, tables_aux3d = timed_phase(27, lambda: phase_aux3d(ak, gs, mesh3d))
    new_paths.update({path: (k2, 0) for path, k2 in k2_aux3d.items()})
    del mesh3d
    torch.cuda.empty_cache()
    paths_28, space1, bw28 = timed_phase(28, lambda: phase_semilinear(ak, gs, ls, pts, cells, bnd))
    new_paths.update(paths_28)
    torch.cuda.empty_cache()
    new_paths.update(timed_phase(29, lambda: phase_neumann(ak, gs, ls, pts, cells, bnd, space1, space2)))
    del space2
    torch.cuda.empty_cache()
    paths_30, bw30, k2_backward = timed_phase(30, lambda: phase_differentiable(ak, gs, ls, space1))
    new_paths.update(paths_30)
    del space1
    torch.cuda.empty_cache()
    new_paths.update(timed_phase(31, lambda: phase_slice11(ak, gs, ls, pts, cells, bnd, amg_run)))
    del amg_run
    k2_backward_launches = bw28 + bw30
    log("K2 / K6 launches by path of phases 20-31: " + "; ".join(
        f"{path} {k2} / {k6}" for path, (k2, k6) in new_paths.items())
        + f"; K2 backward launches {k2_backward_launches} (phase 28 {bw28}, phase 30 {bw30})")
    k2_launches += sum(k2 for k2, _ in new_paths.values())
    k6_launches += sum(k6 for _, k6 in new_paths.values())
    torch.cuda.empty_cache()
    sharded, halo_checks, nccl = timed_phase(32, lambda: phase_sharded(ak, gs, ds, pts, cells, bnd),
                                             True)
    by_kernel = {k: {path: row[k] for path, row in sharded.items() if row.get(k)}
                 for k in ("K2", "K6", "K7", "KC")}
    log("32 launches by path: " + "; ".join(f"{k} {v}" for k, v in by_kernel.items()))
    k2_launches += sum(by_kernel["K2"].values())
    k6_launches += sum(by_kernel["K6"].values())
    k7_launches += sum(by_kernel["K7"].values())
    log(f"K2 launches on float32 values with a float64 x in phases 8-32: "
        f"{gs.ell_spmv_widened_launches}")
    kc_launches = sum(kc for kc, _ in COARSE_BY_PHASE.values())
    log("KC launches by phase (card coarse solves on the plain loop): " + "; ".join(
        f"{phase} {kc} ({plain})" for phase, (kc, plain) in COARSE_BY_PHASE.items())
        + f"; in all {kc_launches}")
    kc, t_kc = synced_seconds(lambda: phase_coarse_cg(grid_mg, plain_coarse_cg, StructuredPoisson))
    log(f"phase 33: {t_kc:.2f} s")
    level_launches = sum(LEVEL_BY_PHASE.values())
    log("stage-kernel launches by phase: " + "; ".join(
        f"{phase} {n}" for phase, n in LEVEL_BY_PHASE.items()) + f"; in all {level_launches}")
    levels, t_levels = synced_seconds(lambda: phase_level_kernels(grid_mg))
    log(f"phase 34: {t_levels:.2f} s")

    kernels = [dict(
        name="p1_stencil_layers",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_stencil.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:398",
        launches=launches,
        **k1,
    ), dict(
        name="ell_spmv",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/ell_spmv.cu",
        replaces="fdapde_core_tpu/ops/pallas_gather_spmv.py:563",
        launches=k2_launches,
        launches_backward=k2_backward_launches,
        **k2,
        compact={"P2": compact_p2, "gendel": compact_gendel},
        mixed=dict(k2_mixed, launches=gs.ell_spmv_widened_launches),
        backward=k2_backward,
        sliced=k2_sliced,
        ell_3d={"float64": tables_gen3d["torch.float64"], "float32": tables_gen3d["torch.float32"]},
        aux_3d=tables_aux3d,
        launches_sharded=by_kernel["K2"],
        halo=halo_checks["K2 halo"],
    ), dict(
        name="p1_stiffness_2d",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_local_stiffness.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:50",
        launches=k6_launches,
        launches_sharded=by_kernel["K6"],
        **k456["K6"],
    ), dict(
        name="p1_stiffness_edges",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_local_stiffness.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:107",
        **k456["K4"],
    ), dict(
        name="p1_stiffness_edges_offdiag",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_local_stiffness.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:152",
        **k456["K5"],
    ), dict(
        name="p1_offdiag_planes",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_stencil.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:242",
        **k3,
    ), dict(
        name="dia_spmv",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/dia_spmv.cu",
        replaces="fdapde_core_tpu/ops/pallas_dia.py:50",
        launches=k7_launches,
        launches_sharded=by_kernel["K7"],
        halo=halo_checks["K7 halo"],
        **k7["DIA path"],
    ), dict(
        name="grid_coarse_cg",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/grid_coarse_cg.cu",
        replaces=None,
        launches=kc_launches,
        launches_by_phase={phase: kc for phase, (kc, _) in COARSE_BY_PHASE.items()},
        plain_on_card_by_phase={phase: plain for phase, (_, plain) in COARSE_BY_PHASE.items()},
        launches_sharded=by_kernel["KC"],
        **kc,
    ), dict(
        name="grid_mg_levels",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/grid_mg_levels.cu",
        replaces=None,
        launches=level_launches,
        launches_by_phase=LEVEL_BY_PHASE,
        launches_phase_34=levels["launches"],
        host_us=levels["host_us"],
        shapes=levels["shapes"],
    )]
    log("32 NCCL ms a call in the one-rank group: " + json.dumps(nccl))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)  # again beside the results, which a log cut to its end keeps
    print(json.dumps({"kernels": kernels}))
    check(not COARSE_FAULTS, "; ".join(COARSE_FAULTS))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
