"""Matrix-product FLOPs of one call of a function.

Counterpart of ``moleculesde_tpu/utils/flops.py::matmul_flops``: the sum
of ``2 * batch * M * N * K`` over the matrix products and convolutions a
call runs, forward and whatever backward it runs, elementwise work
excluded, so it is a lower bound on the FLOPs executed.  It is built on
``torch.utils.flop_counter.FlopCounterMode``, of whose entries it keeps the
matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``; ``einsum`` and
``matmul`` reach the mode as these) and the convolutions.

The hand-written kernels launch through ``ctypes``, where the mode sees
nothing.  So each kernel wrapper of ``ops/`` calls :func:`report_flops`
where it launches, with the FLOPs that the mode counts on the kernel's
plain version at the same shapes (a small function beside each kernel
computes them).  A call's count is then the same whichever of the two
runs.
"""

from __future__ import annotations

from typing import List

from torch.utils.flop_counter import FlopCounterMode

# the FlopCounterMode entries that count matrix products and convolutions
# (its attention entries are left out: no path of the port calls them)
KEPT = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
                  "convolution_backward", "convolution_overrideable", "cudnn_convolution",
                  "_slow_conv2d_forward"})

# the kernels' reports to each matmul_flops call in progress, innermost
# last.  Process-wide, not thread-local: autograd runs a CUDA backward on
# its own device threads, where the kernels' backward wrappers report.
_REPORTED: List[List[int]] = []


def report_flops(flops: int) -> None:
    """Add a kernel launch's matrix-product FLOPs to every count in
    progress (nothing when none is)."""
    for reported in _REPORTED:
        reported[0] += int(flops)


def matmul_flops(fn, *args, **kwargs) -> int:
    """Matrix-product FLOPs of one call of ``fn(*args, **kwargs)``, which
    this runs once (``jax.make_jaxpr`` traces without running): its
    forward and any backward it runs inside, the kernels' reports
    included."""
    _REPORTED.append([0])
    try:
        with FlopCounterMode(display=False) as mode:
            fn(*args, **kwargs)
    finally:
        reported = _REPORTED.pop()[0]
    # the mode has no "Global" entry when the call ran no counted operator
    return reported + sum(n for op, n in mode.get_flop_counts().get("Global", {}).items()
                          if str(op).split(".")[-1] in KEPT)
