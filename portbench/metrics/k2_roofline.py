"""K2's share of its roofline, in %: the bytes its launches in the traced
window must move (``k2_bytes``: stored entries, the operand once, the
result once; bandwidth-bound, against the H100's 3.35 TB/s at 700 W) over
the device time of those launches in the profiler's trace. The bytes are
recorded by a wrapper around K2's two entry points, installed for the
traced window only."""

from portbench.harness.instruments import install_k2_recorder, k2_bytes
from portbench.metrics.k2_bytes import HBM_BYTES_PER_S

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", "kernel K2", "solve_s"
WINDOW = "traced"
# K2's kernels in csrc/ell_spmv.cu: the compact form and the sliced form's two
KERNELS = ("ell_spmv_kernel", "sell_rows_kernel", "sell_cols_kernel")


def install(run):
    return install_k2_recorder(run.rec)


def read(run):
    t = run.traced.trace
    if t is None:
        return None
    secs = sum(e - s for s, e, name in t.kernels if any(k in name for k in KERNELS)) / 1e9
    if secs <= 0.0:
        return None
    return 100.0 * k2_bytes(run.traced.launches) / HBM_BYTES_PER_S / secs
