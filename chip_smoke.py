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
    column equal to its vector launch bitwise; torch.sparse CSR as SpMM.

Prints one JSON line of per-kernel results (each with its bound on the
card from this run's shapes: bytes over 3.35 TB/s or operations over the
type's peak, whichever is larger; K2's entry is the compact (9, 10.25M)
ELL of phase 7, with the sliced form on phase 18's Psi^T under "sliced"),
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
    nd = x.shape[0]
    nfull = (nd // S) * S
    i = torch.arange(nd, device=DEVICE)
    p = torch.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    pinv = torch.where(i < nfull, (i // S) * S + (pow(G, -1, S) * (i % S)) % S, i)
    cells = p[torch.stack([c0, c1, c2], dim=1).long()].to(torch.int32)
    return x[pinv], y[pinv], cells, bnd[pinv]


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
        got = gs.ell_spmv(V, C, xv)
        ref = gs.ell_spmv_reference(V, C, xv)
        bound = V.shape[0] * torch.finfo(acc).eps * gs.ell_spmv_reference(V.abs(), C, xv.abs())
        torch.cuda.synchronize()
        err = (got - ref).abs()
        log(f"K2 {name} ({V.shape[0]}, {V.shape[1]}) n_src={src}: max|kernel-plain| = "
            f"{err.max().item():.3e}, max err/bound = "
            f"{(err / bound.clamp_min(torch.finfo(acc).tiny)).max().item():.3e}")
        check(bool((err <= bound).all()), f"K2 {name} disagrees with its plain version")
        check(bool(torch.isfinite(got).all()), f"K2 {name} produced non-finite values")
        check(torch.equal(got, gs.ell_spmv(V, C, xv)), f"K2 {name} is not bitwise stable")
        if name in ("float32", "float64"):
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
            out[name] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, **b)
    return out["float32"]


def true_rel_residual(E, bnd, x, b_mod, gs):
    """||b_mod - A~ x|| / ||b_mod|| with the Dirichlet-masked operator
    applied through the plain SpMV in f64."""
    free = (~bnd).to(torch.float64)
    Ax = gs.ell_spmv_reference(E.vals.double(), E.cols, x * free) * free + x * bnd
    return (torch.linalg.norm(b_mod - Ax) / torch.linalg.norm(b_mod)).item()


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
    # the aux grid's P^T, K2's sliced form in float32, against its plain
    # version, and timed beside the index_add_ it replaces (atomics)
    PT, aux = model.aux.PT, model.aux
    r = torch.rand(PT.shape[1], generator=torch.Generator(device=DEVICE).manual_seed(SEED + 10),
                   dtype=torch.float32, device=DEVICE) - 0.5
    got, ref = PT @ r, gs.sliced_ell_spmm_reference(PT, r)
    # the bilinear weights are >= 0, so |P^T| = P^T
    bound = PT.width * torch.finfo(torch.float32).eps * gs.sliced_ell_spmm_reference(PT, r.abs())
    check(bool(((got - ref).abs() <= bound).all()), "K2 sliced on the aux grid's P^T disagrees")
    check(torch.equal(got, PT @ r), "K2 sliced on the aux grid's P^T is not bitwise stable")
    m2 = PT.shape[0]
    scatter = lambda: torch.zeros(m2, dtype=r.dtype, device=DEVICE).index_add_(  # noqa: E731
        0, aux.idx.reshape(-1), (aux.w * r[None, :]).reshape(-1))
    t_pt, t_ia = time_ms(lambda: PT @ r, 20), time_ms(scatter, 20)
    log(f"aux grid P^T {PT.shape} float32, {PT.dest.shape[0]} entries, padding ratio "
        f"{PT.padding_ratio():.3f}: K2 sliced {t_pt:.4f} ms (within the bound of its plain version, "
        f"bitwise stable), the index_add_ it replaces {t_ia:.4f} ms")

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


def phase_pde_main_path(ak, gs, ls, pts, cells, bnd, t_mesh):
    """PDE(mesh, -laplacian()).init().solve() at nx = 720 on the mesh
    delaunay_mesh built in t_mesh seconds; returns (pde, K6 launches)."""
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

    # true residual of the masked system, recomputed on the host in f64,
    # beside its rounding floor eps || |A~| |x| || / ||b~||
    A = pde.stiff().to_scipy()
    free = ~pde.space.boundary_dofs
    xh = x.cpu().numpy()
    b_mod = pde.force().cpu().numpy() * free
    r = b_mod - (free * (A @ (free * xh)) + ~free * xh)
    rel = float(np.linalg.norm(r) / np.linalg.norm(b_mod))
    absA = abs(A)
    floor = float(np.finfo(np.float64).eps * np.linalg.norm(
        free * (absA @ (free * abs(xh))) + ~free * abs(xh)) / np.linalg.norm(b_mod))
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
    return pde, k6_launches


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


def k2_table(gs, name, S, k=1, transposed=False):
    """K2's sliced form on the product S @ X that a path launches, X float64
    random: a vector (k = 1) or an (n_src, k) block, row-major or the
    transposed view of a row-major (k, n_src) block. Checks: the kernel
    against its plain version within the per-row bound width eps sum|a x|;
    bitwise stable; each block column equal to the vector launch on that
    column; equal to today's route (one thread per row either way). Times,
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
    check(ms <= old_ms, f"K2 sliced on {name} ({ms:.4f} ms) is slower than today's route "
                        f"({old_ms:.4f} ms)")
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
    pde, k6_launches = phase_pde_main_path(ak, gs, ls, pts, cells, bnd, t_mesh)
    phase_pde_harmonic(pde)
    mesh = pde.domain
    del pde
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
