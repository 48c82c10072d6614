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
   multigrid -> mixed-precision MG-CG solve, with the kernel's launch count
   reset just before and read just after;
5. harmonic check at n = 256 in f64: Dirichlet data g = x + y is
   reproduced to 1e-10;
6. 500 Jacobi-CG iterations on the n = 3200 operator with f32 and bf16
   stencil storage.

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


def phase_main_path(ak, StructuredPoisson):
    """StructuredPoisson(3200) end to end; returns (model, launches)."""
    ak.p1_stencil_launches = 0
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fdapde_core_tpu_torch import _build
    from fdapde_core_tpu_torch.models import StructuredPoisson
    from fdapde_core_tpu_torch.ops import assembly_kernels as ak
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
    model, launches = phase_main_path(ak, StructuredPoisson)
    phase_harmonic(StructuredPoisson)
    phase_jacobi(model, grid_cg)

    kernels = [dict(
        name="p1_stencil_layers",
        route="cuda",
        source="fdapde_core_tpu_torch/csrc/p1_stencil.cu",
        replaces="fdapde_core_tpu/ops/pallas_assembly.py:398",
        launches=launches,
        **k1,
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
