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
   within 150 inner iterations;
9. MatrixFreePoisson on the unscrambled n = 3200 mesh (aux grid, f64 ELL
   on K2) converges to 1e-9;
10. harmonic check on the scrambled n = 256 mesh through the lane path:
    Dirichlet data g = x + y is reproduced to 1e-9.

Prints one JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device or
without the package beside it.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

N_MAIN = 3200
N_ODD = 257  # not a multiple of 128
N_HARMONIC = 256
CG_ITERS = 500
SEED = 1234
DEVICE = "cuda"
SCRAMBLE = (4096, 1361)  # block size S and multiplier G (coprime) at n = 3200
SCRAMBLE_SMALL = (512, 397)  # at n = 256


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
    """Mean device milliseconds per call over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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
    log(f"K1 n={n} float32: kernel {k1:.4f} / {k2:.4f} ms "
        f"({cells / (ms * 1e-3):.4e} elements/s), plain {p1:.4f} / {p2:.4f} ms "
        f"({cells / (plain_ms * 1e-3):.4e} elements/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def zero_launch_counts(ak, gs):
    """Set every kernel wrapper's launch count to 0."""
    ak.p1_stencil_launches = 0
    gs.ell_spmv_launches = 0


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
            kernel = lambda: gs.ell_spmv(V, C, xv)  # noqa: E731
            plain = lambda: gs.ell_spmv_reference(V, C, xv)  # noqa: E731
            k1, p1 = time_ms(kernel, 50), time_ms(plain, 5)
            k2, p2 = time_ms(kernel, 50), time_ms(plain, 5)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            nbytes = K * n * (V.element_size() + 4) + 2 * n * xv.element_size()
            log(f"K2 {name} n={N_MAIN}: kernel {k1:.4f} / {k2:.4f} ms "
                f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes / 1e9:.3f} GB computed), "
                f"plain {p1:.4f} / {p2:.4f} ms")
            out[name] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fdapde_core_tpu_torch import _build
    from fdapde_core_tpu_torch.models import StructuredPoisson
    from fdapde_core_tpu_torch.ops import assembly_kernels as ak
    from fdapde_core_tpu_torch.ops import gather_spmv as gs
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
