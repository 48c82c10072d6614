"""How the port's data-fitting path scales, at reduced sizes.

Runs fdapde_core_tpu_torch (on the card; --device cpu for a CPU run) to
show how the GCV minimum
of SmoothingRegression and the CG iterations of SpaceTimeSmoothing move
with the problem size; chip_smoke.py's phases 18 and 19 are sized from
these two curves.

    python examples/torch_data_fitting_scaling.py --device cpu gcv --nx 90 \\
        --points 29000 --lambdas 0.1 3 30 300
    python examples/torch_data_fitting_scaling.py --device cpu space-time \\
        --meshes 16 32 64 128

`gcv`: bench.py's `general` Delaunay mesh at --nx, --points uniform on
[-0.02, 1.02]^2 (the inside ones observed), y = sin(2 pi x) cos(2 pi y) +
0.2 eps; per lambda the Hutchinson GCV score (8 probes), the fit's CG
iterations and the RMSE at 20,000 interior points.
`space-time`: 2,000 sites x 365 times, Interval(0, 1, 24) cubic splines,
lam_s 1, lam_t 0.1, the separable field of tests/test_regression.py plus
0.1 noise; per unit_square_mesh size the fit's iterations and RMSE.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def delaunay_mesh(nx, seed=7, amp=0.35):
    """bench.py's `general` mesh: the (nx+1)^2 lattice with interior nodes
    jittered by +-amp h, scipy Delaunay (the mesh of chip_smoke.py's phases
    12-18)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    pts[interior] += rng.uniform(-amp, amp, size=(interior.sum(), 2))
    pts /= nx
    return pts, Delaunay(pts).simplices.astype(np.int32), ~interior


def gcv(args):
    import fdapde_core_tpu_torch as fdt
    from fdapde_core_tpu_torch.models import SmoothingRegression

    pts, cells, bnd = delaunay_mesh(args.nx)
    mesh = fdt.Triangulation(pts, cells, bnd)
    rng = np.random.default_rng(5)
    obs = rng.uniform(-0.02, 1.02, size=(args.points, 2))
    obs = obs[mesh.locate(obs) >= 0]

    def truth(p):
        return np.sin(2 * np.pi * p[:, 0]) * np.cos(2 * np.pi * p[:, 1])

    y = truth(obs) + 0.2 * rng.normal(size=obs.shape[0])
    model = SmoothingRegression(mesh, -fdt.laplacian(), device=args.device)
    for lam in args.lambdas:
        t0 = time.perf_counter()
        score = model.gcv(obs, y, lam, n_probes=8, seed=0, exact=False, rtol=1e-10,
                          maxiter=20000)
        iters = model.solve_info_.iterations
        grid = rng.uniform(0.1, 0.9, size=(20000, 2))
        rmse = np.sqrt(((model.predict(grid).cpu().numpy() - truth(grid)) ** 2).mean())
        print(f"nx={args.nx} n={obs.shape[0]} lambda={lam:g}: GCV {score:.6e}, fit {iters} "
              f"iterations, RMSE {rmse:.4e}, {time.perf_counter() - t0:.1f} s", flush=True)


def space_time(args):
    from fdapde_core_tpu_torch.geometry import Interval, unit_square_mesh
    from fdapde_core_tpu_torch.models import SpaceTimeSmoothing

    rng = np.random.default_rng(0)
    locs = rng.uniform(0.05, 0.95, size=(2000, 2))
    times = np.linspace(0.0, 1.0, 365)

    def truth(p, t):
        return np.sin(np.pi * p[:, 0:1]) * np.sin(np.pi * p[:, 1:2]) * np.exp(-t[None, :])

    Y = truth(locs, times) + 0.1 * rng.normal(size=(2000, 365))
    for n in args.meshes:
        model = SpaceTimeSmoothing(unit_square_mesh(n), Interval(0.0, 1.0, 24), device=args.device)
        t0 = time.perf_counter()
        model.fit(locs, times, Y, 1.0, 0.1, rtol=1e-10)
        seconds = time.perf_counter() - t0
        grid, t_eval = rng.uniform(0.15, 0.85, size=(100, 2)), np.linspace(0.1, 0.9, 7)
        pred = model.predict(grid, t_eval).cpu().numpy()
        rmse = np.sqrt(((pred - truth(grid, t_eval)) ** 2).mean())
        print(f"unit_square_mesh({n}) ({model.space.n_dofs} dofs): {model.solve_info_.iterations} "
              f"iterations, converged {model.solve_info_.converged}, RMSE {rmse:.4e}, "
              f"{seconds:.2f} s", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    sub = parser.add_subparsers(dest="which", required=True)
    g = sub.add_parser("gcv")
    g.add_argument("--nx", type=int, default=90)
    g.add_argument("--points", type=int, default=29000)
    g.add_argument("--lambdas", type=float, nargs="+", default=[0.1, 3.0, 30.0, 300.0])
    g.set_defaults(run=gcv)
    st = sub.add_parser("space-time")
    st.add_argument("--meshes", type=int, nargs="+", default=[16, 32, 64])
    st.set_defaults(run=space_time)
    args = parser.parse_args()
    args.run(args)


if __name__ == "__main__":
    main()
