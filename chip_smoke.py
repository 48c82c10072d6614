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
   a multiple of the block); per-row tolerance K eps(acc) sum_k |vals x|;
   bitwise stable; both timed with CUDA events in float32 and float64;
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
    at the sort windows SIGMAS (padding and time of each, results equal),
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
    rtol 1e-12, consistent and lumped mass: every implicit-Euler step
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
    aux-grid step at dt = 1e-7 from u0, converged within 1500 iterations; at
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
    against its plain version within the per-row bound, timed against its
    bound, and k2_table on the assembled matrix (sliced form, the compact
    table padded to the longest row, CSR, plain); P2 reproduces
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
    and the f64 one of the outer residuals, within the per-row bound,
    timed against a CSR SpMV, its plain version and its bounds;
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
    f32 against its plain version within the per-row bound, timed against
    its bound, CSR and plain; u = x + 2y - z reproduced to 1e-9 max|u|;
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
    grid (as the JAX package's does) and reproduces u = x + 2y - z to 1e-9.
    Phases 20-27 print their seconds and K2 / K6 launches by path.

Prints one JSON line of per-kernel results (each with its bound on the
card from this run's shapes: bytes over 3.35 TB/s or operations over the
type's peak, whichever is larger; K2's entry is the compact (9, 10.25M)
ELL of phase 7, with the sliced form on phase 18's Psi^T under "sliced",
the 3D ELL of phase 26 under "ell_3d" and the 3D aux grid's P and P^T of
phase 27 under "aux_3d"),
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
# phase 23's one aux-grid step at DT_MF: its iterations grow with n at
# dt ~ h^2 (the grid stencil is the unshifted Laplacian, as in JAX)
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


def ell_csr(V, C):
    """A torch.sparse CSR tensor of a square compact (K, n) ELL's stored
    entries: the padding (col = row after the row's diagonal) is left out."""
    n = V.shape[1]
    diag = C == torch.arange(n, dtype=C.dtype, device=C.device)[None, :]
    keep = (~diag | (torch.cumsum(diag, 0) == 1)).T
    crow = torch.zeros(n + 1, dtype=torch.int64, device=C.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow, C.T[keep].long(), V.T[keep], (n, n), check_invariants=False)


def k2_compact_check(gs, name, V, C, x):
    """K2's compact form on the (K, n) table (V, C) at x against its plain
    version within the per-row bound K eps(acc) sum_k |v x|, bitwise stable.
    Returns (max|kernel - plain|, max err / bound)."""
    acc = gs.accumulation_dtype(V.dtype)
    got, ref = gs.ell_spmv(V, C, x), gs.ell_spmv_reference(V, C, x)
    bound = V.shape[0] * torch.finfo(acc).eps * gs.ell_spmv_reference(V.abs(), C, x.abs())
    err = (got - ref).abs()
    check(bool((err <= bound).all()), f"K2 on {name} disagrees with its plain version")
    check(bool(torch.isfinite(got).all()), f"K2 on {name} produced non-finite values")
    check(torch.equal(got, gs.ell_spmv(V, C, x)), f"K2 on {name} is not bitwise stable")
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
    cases = {
        "float32": (E64.vals.float(), E64.cols, n),
        "float64": (E64.vals, E64.cols, n),
        "bfloat16": (E64.vals.bfloat16(), E64.cols, n),
        "float32 rectangular": (
            E64.vals[:, :n_rect].float().contiguous(),
            ((E64.cols[:, :n_rect].long() * 7 + 3) % n_src).to(torch.int32).contiguous(),
            n_src,
        ),
    }
    out = {}
    for name, (V, C, src) in cases.items():
        acc = gs.accumulation_dtype(V.dtype)
        xv = torch.rand(src, generator=gen, dtype=torch.float64, device=DEVICE).to(acc) - 0.5
        err, ratio = k2_compact_check(gs, name, V, C, xv)
        log(f"K2 {name} ({V.shape[0]}, {V.shape[1]}) n_src={src}: max|kernel-plain| = "
            f"{err:.3e}, max err/bound = {ratio:.3e}")
        if name in ("float32", "float64"):
            ref = gs.ell_spmv_reference(V, C, xv)
            # the same product as one library call: a CSR SpMV through
            # torch.sparse on the same K entries per row (timed, never used)
            csr = torch.sparse_csr_tensor(
                torch.arange(0, K * n + 1, K, dtype=torch.int64, device=DEVICE),
                C.T.contiguous().reshape(-1).long(), V.T.contiguous().reshape(-1), (n, src),
                check_invariants=False)
            lib_err = (csr @ xv - ref).abs().max().item()
            kernel = lambda: gs.ell_spmv(V, C, xv)  # noqa: E731
            plain = lambda: gs.ell_spmv_reference(V, C, xv)  # noqa: E731
            library = lambda: csr @ xv  # noqa: E731
            k1, p1, l1 = time_ms(kernel, 50), time_ms(plain, 5), time_ms(library, 50)
            k2, p2, l2 = time_ms(kernel, 50), time_ms(plain, 5), time_ms(library, 50)
            ms, plain_ms, library_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
            del csr
            nbytes = K * n * (V.element_size() + 4) + 2 * n * xv.element_size()
            b = least_time(nbytes, 2 * K * n, V.dtype)
            log(f"K2 {name} n={N_MAIN}: kernel {k1:.4f} / {k2:.4f} ms "
                f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes / 1e9:.3f} GB computed), "
                f"plain {p1:.4f} / {p2:.4f} ms, torch.sparse CSR {l1:.4f} / {l2:.4f} ms "
                f"(max|csr-plain| {lib_err:.3e}); bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
    return out["float32"]


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
    check(its <= 150, f"lane refined solve took {its} > 150 inner iterations")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
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


def delaunay_mesh(nx, seed=7, amp=0.35):
    """bench.py's `general` mesh (bench.py:695-705): the (nx+1)^2 lattice
    with interior nodes jittered by +-amp h, scipy Delaunay. Host NumPy:
    (nodes (N, 2), cells (C, 3) int32, boundary (N,) bool)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    return pts, Delaunay(pts).simplices.astype(np.int32), ~interior


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
    Returns (a closure computing S @ X that way, the padding ratio)."""
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
        return (lambda: gs.ell_spmv(vals, cols, X)), D * n / S.nnz
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

    return run, D * n / S.nnz


def k2_table(gs, name, S, k=1, transposed=False, race=True):
    """K2's sliced form on the product S @ X that a path launches, X float64
    random: a vector (k = 1) or an (n_src, k) block, row-major or the
    transposed view of a row-major (k, n_src) block. Checks: the kernel
    against its plain version within the per-row bound width eps sum|a x|;
    bitwise stable; each block column equal to the vector launch on that
    column; equal to today's route (one thread per row either way); with
    ``race``, not slower than today's route (off for tables so small that
    both are one launch's latency). Times,
    by CUDA events, two alternating runs after a warm-up: the kernel,
    today's route (the (D, n) ELL or the I_c (x) S copies, built here), a
    torch.sparse CSR product (cuSPARSE SpMV or SpMM, timed, never used) and
    the plain version; the bound counts each stored entry once (12 B), X
    and Y once. Returns the measurements."""
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
    old, old_padding = today_route(gs, S, X)
    same = torch.equal(got, old())
    check(same, f"K2 on {name} differs from today's route")

    csr = csr_of(S.with_vals(S.vals.double()))
    lib_err = (csr @ X - ref).abs().max().item()
    kernel, library = (lambda: S @ X), (lambda: csr @ X)
    n1, o1, l1 = time_ms(kernel, 30), time_ms(old, 30), time_ms(library, 30)
    n2, o2, l2 = time_ms(kernel, 30), time_ms(old, 30), time_ms(library, 30)
    plain_ms = time_ms(lambda: gs.sliced_ell_spmm_reference(A, X), 3)
    ms, old_ms, library_ms = (n1 + n2) / 2, (o1 + o2) / 2, (l1 + l2) / 2
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
        f"{nbytes / 1e9:.4f} GB), today's route {o1:.4f} / {o2:.4f} ms ({old_ms / ms:.2f}x), "
        f"torch.sparse CSR {l1:.4f} / {l2:.4f} ms (max|csr-plain| {lib_err:.3e}), plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
        f"{100 * b['bound_ms'] / ms:.0f} %)")
    return dict(table=f"{name} {tuple(S.shape)}", max_abs_err=err.max().item(), ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, today_ms=old_ms,
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
            f"{t_solve:.4f} s; Jacobi-CG iterations per step {info['iterations'].tolist()}, all "
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
    """Times every cls.build (AMG's, an aux grid's) while active:
    [(built object, host seconds)]."""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        self.raw, self.builds = self.cls.__dict__["build"], []
        bound = self.cls.build

        def timed(*args, **kwargs):
            obj, t = synced_seconds(lambda: bound(*args, **kwargs))
            self.builds.append((obj, t))
            return obj

        self.cls.build = staticmethod(timed)
        return self.builds

    def __exit__(self, *exc):
        self.cls.build = self.raw


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
    lifted surface. Returns {path: (K2, K6)}."""
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
    del pde, x, mg, builds, x_h

    out.update(phase_surface(ak, gs, ls))
    return out


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
    nodes_s = torch.stack([x, y], 1)
    name = f"aux grid, scrambled n={N_MAIN}, dt={DT_MF:g}, one step"
    zero_launch_counts(ak, gs)
    model = MatrixFreeParabolic(nodes_s, cells, bnd, DT_MF, device=DEVICE)
    u0 = torch.sin(np.pi * x) * torch.sin(np.pi * y)
    (_, its, rel), t = synced_seconds(lambda: model.step(u0, rtol=1e-9, maxiter=AUX_H2_MAXITER))
    out[name] = (gs.ell_spmv_launches, ls.p1_stiffness_2d_launches)
    log(f"23 MatrixFreeParabolic {name}: preconditioner {model.preconditioner}; {int(its)} "
        f"iterations (held to {AUX_H2_MAXITER}) in {t:.4f} s ({1e3 * t / max(int(its), 1):.1f} ms "
        f"an iteration), true rel residual {float(rel):.3e}; K2 launches {out[name][0]}")
    check(model.preconditioner == "auxgrid" and float(rel) <= 1e-9,
          f"the aux-grid step at dt={DT_MF:g} did not reach 1e-9 in {AUX_H2_MAXITER} iterations")
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
    the quadratic reproduction at nx = 256. Returns {path: K2 launches}."""
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

    # K2 on the P2 ELL: the compact (49, n) table against its plain version,
    # timed beside the same matrix in the sliced form (k2_table, whose
    # "today's route" is the compact table padded to the longest row)
    err, ratio = k2_compact_check(gs, "the P2 ELL", E.vals, E.cols, v)
    kernel = lambda: gs.ell_spmv(E.vals, E.cols, v)  # noqa: E731
    plain = lambda: gs.ell_spmv_reference(E.vals, E.cols, v)  # noqa: E731
    c1, p1 = time_ms(kernel, 20), time_ms(plain, 3)
    c2, p2 = time_ms(kernel, 20), time_ms(plain, 3)
    ms = (c1 + c2) / 2
    b_nnz = least_time(nnz * 12 + 2 * n * 8, 2 * nnz, torch.float64)
    b_read = least_time(K * n * 12 + 2 * n * 8, 2 * K * n, torch.float64)
    log(f"24 K2 compact on the P2 ELL ({K}, {n}) f64: max|kernel-plain| {err:.3e} (max err/bound "
        f"{ratio:.3e}), bitwise stable; kernel {c1:.4f} / {c2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
        f"bound on its {nnz} entries {b_nnz['bound_ms']:.4f} ms ({b_nnz['bound_by']}, "
        f"{100 * b_nnz['bound_ms'] / ms:.0f} %), on the {K * n} slots it reads "
        f"{b_read['bound_ms']:.4f} ms ({100 * b_read['bound_ms'] / ms:.0f} %)")
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
    return out


def phase_lane_aux(ak, gs):
    """bench.py's gendel (bench.py:1528-1742) through the model API: a
    Delaunay base red-refined on the card, strip-renumbered, then
    MatrixFreeElliptic(gather_kernel="lane", aux_kernel="lane") with its
    LaneAuxGrid: the apply against the plain one, K2 on P and on the P1
    ELL (f32 and f64), the refined solve to 1e-8 twice. Returns {path: K2
    launches}."""
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
    for Ek in (model.op, E):
        v = torch.rand(n, generator=gen, dtype=Ek.vals.dtype, device=DEVICE) - 0.5
        k2_ell_table(gs, "25 the grown mesh's P1 ELL", Ek, v)
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
    check(out["lane aux solve"] > 0, "the gendel path never launched K2")
    return out


def rounding_floor(gs, E, bnd, x, b_mod, its):
    """iterations x eps || |A~| |x| || / ||b~||: how far a CG's recurrence
    residual may drift from its true one in f64."""
    free = (~bnd).to(torch.float64)
    return its * torch.finfo(torch.float64).eps * (torch.linalg.norm(
        gs.ell_spmv_reference(E.vals.double().abs(), E.cols, x.abs() * free) * free
        + x.abs() * (1 - free)) / torch.linalg.norm(b_mod)).item()


def k2_ell_table(gs, name, E, v):
    """K2's compact form on a square (K, n) ELL E at v: against its plain
    version within the per-row bound, bitwise stable; timed against a
    cuSPARSE CSR SpMV of its stored entries (timed, never used), its plain
    version and its bounds on the entries stored and the slots read.
    Returns the measurements."""
    V, C = E.vals, E.cols
    Kp, n = V.shape
    nnz = ell_nnz(E)
    vb = V.element_size()
    err, ratio = k2_compact_check(gs, name, V, C, v)
    csr = ell_csr(V, C)
    lib_err = (csr @ v - gs.ell_spmv_reference(V, C, v)).abs().max().item()
    ka, ca = time_ms(lambda: gs.ell_spmv(V, C, v), 20), time_ms(lambda: csr @ v, 20)
    kb, cb = time_ms(lambda: gs.ell_spmv(V, C, v), 20), time_ms(lambda: csr @ v, 20)
    p_ms = time_ms(lambda: gs.ell_spmv_reference(V, C, v), 3)
    del csr
    ms = (ka + kb) / 2
    b_nnz = least_time(nnz * (vb + 4) + 2 * n * vb, 2 * nnz, V.dtype)
    b_read = least_time(Kp * n * (vb + 4) + 2 * n * vb, 2 * Kp * n, V.dtype)
    log(f"K2 compact on {name} ({Kp}, {n}) {V.dtype}: max|kernel-plain| {err:.3e} "
        f"(max err/bound {ratio:.3e}), bitwise stable; kernel {ka:.4f} / {kb:.4f} ms, torch.sparse "
        f"CSR {ca:.4f} / {cb:.4f} ms (max|csr-plain| {lib_err:.3e}), plain {p_ms:.4f} ms; padding "
        f"{Kp * n / nnz:.3f} slots read per entry; bound on its {nnz} entries "
        f"{b_nnz['bound_ms']:.4f} ms ({b_nnz['bound_by']}, {100 * b_nnz['bound_ms'] / ms:.0f} %), "
        f"on the {Kp * n} slots it reads {b_read['bound_ms']:.4f} ms "
        f"({100 * b_read['bound_ms'] / ms:.0f} %)")
    return dict(max_abs_err=err, ms=ms, plain_ms=p_ms, library_ms=(ca + cb) / 2, **b_nnz)


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


def timed_phase(number, fn):
    """Run a phase, print its seconds, return its result."""
    out, t = synced_seconds(fn)
    log(f"phase {number}: {t:.2f} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fdapde_core_tpu_torch import _build
    from fdapde_core_tpu_torch.models import StructuredPoisson
    from fdapde_core_tpu_torch.ops import assembly_kernels as ak
    from fdapde_core_tpu_torch.ops import dia_spmv as ds
    from fdapde_core_tpu_torch.ops import gather_spmv as gs
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
    model, launches = phase_main_path(ak, gs, StructuredPoisson)
    phase_harmonic(StructuredPoisson)
    phase_jacobi(model, grid_cg)
    del model
    torch.cuda.empty_cache()

    k2 = phase_k2_vs_plain(gs)
    torch.cuda.empty_cache()
    k2_launches = phase_general_main_path(ak, gs)
    torch.cuda.empty_cache()
    phase_matfree_poisson(ak, gs)
    torch.cuda.empty_cache()
    phase_general_harmonic()
    torch.cuda.empty_cache()

    (pts, cells, bnd), t_mesh = synced_seconds(lambda: delaunay_mesh(NX_PDE))
    k456 = phase_local_stiffness(ak, gs, ls, pts, cells)
    torch.cuda.empty_cache()
    pde, k6_launches, aux_run = phase_pde_main_path(ak, gs, ls, pts, cells, bnd, t_mesh)
    phase_pde_harmonic(pde)
    mesh = pde.domain
    del pde
    torch.cuda.empty_cache()
    new_paths = {}  # phases 20-23: {path: (K2 launches, K6 launches)}
    new_paths.update(timed_phase(20, lambda: phase_parabolic(ak, gs, ls, mesh)))
    new_paths.update(timed_phase(21, lambda: phase_amg(ak, gs, ls, mesh, aux_run)))
    del aux_run
    torch.cuda.empty_cache()
    obs = phase_point_location(mesh)
    torch.cuda.empty_cache()
    k2_reg, k6_reg, k2_sliced = phase_regression(ak, gs, ls, mesh, obs)
    del mesh, obs
    torch.cuda.empty_cache()
    k2_st, k6_st = phase_space_time(ak, gs, ls)
    torch.cuda.empty_cache()
    log(f"K2 launches by path: lane solve {k2_launches}, regression {k2_reg}, space-time {k2_st}; "
        f"K6: PDE init {k6_launches}, regression {k6_reg}, space-time {k6_st}")
    k2_launches += k2_reg + k2_st
    k6_launches += k6_reg + k6_st

    k3 = phase_k3(ak, gs)
    torch.cuda.empty_cache()
    D, k7_launches = phase_dia_main_path(ak, gs, ds, ls)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    G = stencil_from_coords(*perturbed_planes(N_MAIN, torch.float32, gen), N_MAIN)
    k7 = phase_k7(ds, [("DIA path", D, None),
                       (f"flattened n={N_MAIN} stencil", flat_stencil_dia(G), G.__matmul__)])
    del D, G
    torch.cuda.empty_cache()

    lattice, k2_banded = timed_phase(22, lambda: phase_banded(ak, gs))
    new_paths.update({path: (k2, 0) for path, k2 in k2_banded.items()})
    torch.cuda.empty_cache()
    new_paths.update(timed_phase(23, lambda: phase_matfree_parabolic(ak, gs, ls, lattice)))
    del lattice
    torch.cuda.empty_cache()
    new_paths.update({path: (k2, 0) for path, k2 in
                      timed_phase(24, lambda: phase_p2(ak, gs, pts, cells, bnd)).items()})
    torch.cuda.empty_cache()
    new_paths.update({path: (k2, 0) for path, k2 in
                      timed_phase(25, lambda: phase_lane_aux(ak, gs)).items()})
    torch.cuda.empty_cache()
    mesh3d, k2_gen3d, tables_gen3d = timed_phase(26, lambda: phase_gen3d(ak, gs))
    new_paths.update({path: (k2, 0) for path, k2 in k2_gen3d.items()})
    torch.cuda.empty_cache()
    k2_aux3d, tables_aux3d = timed_phase(27, lambda: phase_aux3d(ak, gs, mesh3d))
    new_paths.update({path: (k2, 0) for path, k2 in k2_aux3d.items()})
    del mesh3d
    log("K2 / K6 launches by path of phases 20-27: " + "; ".join(
        f"{path} {k2} / {k6}" for path, (k2, k6) in new_paths.items()))
    k2_launches += sum(k2 for k2, _ in new_paths.values())
    k6_launches += sum(k6 for _, k6 in new_paths.values())

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
        **k2,
        sliced=k2_sliced,
        ell_3d={"float64": tables_gen3d["torch.float64"], "float32": tables_gen3d["torch.float32"]},
        aux_3d=tables_aux3d,
    ), dict(
        name="p1_stiffness_2d",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_local_stiffness.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:50",
        launches=k6_launches,
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
        **k7["DIA path"],
    )]
    log(smi)  # again beside the results, which a log cut to its end keeps
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
