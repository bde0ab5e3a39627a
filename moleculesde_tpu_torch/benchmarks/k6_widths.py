"""K6 (``ops/score_kernel.py::score_eval_fused``) at the widths the JAX
kernel takes past the sampler's (hidden 32, 8 heads, basis width 128): the
kernel against its plain version on seeded operands at every case of
``WIDTH_GRID`` (each hidden width of 8-128, each head count of 1-8, each
basis width of 32-256, three (modules, layers a module) shapes and four
n_max, in combinations), variants 1 and 2, f32 and bf16, two launches bit
for bit; with ``--times`` the kernel's and plain version's device times
(CUDA-graph replay, ``timing.py``).  ``chip_smoke.py`` phase 22 and the
card tests (``tests/test_torch_port_kernels.py -k widths``) draw their
operands with :func:`width_operands`.

    python3 -m moleculesde_tpu_torch.benchmarks.k6_widths [--times]

``--profile``: K6's launches by name (the layered plan's passes: front,
node, GAT, basis) and their device ms per evaluation (``torch.profiler``,
5 evaluations), and the evaluation's device ms by CUDA-graph replay, at
``PROFILE_CASES`` (the sampler's widths at n_max 1024, B = 2, the chain's
shape with the model 64 and 128 wide, and the model 128 wide at n_max
1024, B = 2), in whichever checkout is first on the path, so a parent
checkout runs the same lines (a width it refuses is skipped); in turns,
parent / this / this / parent:

    for p in out/parent . . out/parent; do env PYTHONPATH=$p \\
        python3 moleculesde_tpu_torch/benchmarks/k6_widths.py --profile; done

``--phases``: the GAT pass's phases (logits, the softmax's merge, message,
LayerNorm / FFN) at ``PROFILE_CASES`` from a ``-DPHASE_PROFILE`` build of
``csrc/score_layered.cu`` (this checkout's only).

Bars: f32 1e-5 and bf16 2e-2 of max |plain|, K6's bars; each line prints
the reading, and the script exits 1 if any case fails.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

# (hidden, heads, basis width, modules, GAT layers a module, n_max, B)
WIDTH_GRID = (
    (8, 8, 32, 2, 2, 8, 4),        # one channel a head
    (16, 4, 64, 3, 2, 32, 8),
    (24, 8, 192, 1, 3, 129, 2),    # hidden not a multiple of 32; past n_max 128
    (48, 2, 256, 2, 2, 300, 1),
    (64, 1, 128, 2, 2, 32, 16),    # a head of 64 channels, two slices of 32
    (64, 8, 256, 3, 2, 129, 2),
    (128, 4, 64, 1, 3, 8, 4),
    (128, 1, 192, 2, 2, 32, 4),    # one head of all 128 channels
    (16, 2, 32, 1, 3, 300, 1),
    (48, 8, 64, 3, 2, 8, 2),
    (24, 1, 128, 2, 2, 32, 2),
    (32, 8, 128, 3, 2, 32, 8),     # the sampler's widths at 130 segments
    (32, 4, 128, 2, 2, 64, 4),     # hidden 32 with 4 heads
    (128, 8, 128, 2, 2, 1024, 2),  # the widest hidden at n_max 1024
)
TOL = {False: 1e-5, True: 2e-2}
PROFILE_CASES = ((32, 8, 128, 2, 2, 1024, 2), (64, 8, 128, 2, 2, 32, 64),
                 (128, 8, 128, 2, 2, 32, 64), (128, 8, 128, 2, 2, 1024, 2))


def width_operands(dev, b: int, n: int, h: int, coff_dim: int, num_layers: int,
                   num_convs: int, variant: int, seed: int = 0):
    """(pos, node_attr, edge_attr_2d, pair_mask, packed) drawn on ``dev``:
    weights per packed segment as the models initialise them (kernels
    normal / sqrt(fan-in), LayerNorm scales near 1, small non-zero biases
    and offsets, standard normal Fourier rows), positions 1.5 x normal, a
    mask of ~60% of the pairs without self-pairs, one destination with no
    valid source."""
    from moleculesde_tpu_torch.ops.score_kernel import score_param_layout

    gen = torch.Generator(device=dev).manual_seed(seed)
    layout, total = score_param_layout(variant, h, coff_dim, num_layers, num_convs)
    packed = torch.zeros(total, device=dev)
    for name, shape, off in layout:
        part = name.rsplit(".", 1)[-1]
        w = torch.randn(shape, device=dev, generator=gen)
        if len(shape) == 2:
            w = w / math.sqrt(shape[0])
        elif part in ("s1", "s2"):
            w = 1.0 + 0.1 * w
        elif name not in ("coff_W", "dist_W"):
            w = 0.1 * w
        packed[off:off + w.numel()] = w.reshape(-1)
    pos = 1.5 * torch.randn(b, n, 3, device=dev, generator=gen)
    node = torch.randn(b, n, h, device=dev, generator=gen)
    edge = torch.randn(b, n, n, h, device=dev, generator=gen)
    mask = torch.rand(b, n, n, device=dev, generator=gen) < 0.6
    mask[:, torch.arange(n), torch.arange(n)] = False
    mask[0, :, 0] = False
    return pos, node, edge, mask.float(), packed


def case_name(case, variant: int, bf16: bool) -> str:
    h, heads, cd, layers, convs, n, b = case
    return (f"K6 hidden {h} heads {heads} basis {cd} L{layers}xC{convs} n_max {n} B={b} "
            f"v{variant} {'bf16' if bf16 else 'f32'}")


def check_case(dev, case, variant: int, bf16: bool, times: bool = False) -> dict:
    """One case: the plan, the error relative to max |plain|, two launches
    bit for bit, and with ``times`` the device ms of both versions."""
    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.score_kernel import (
        score_eval_fused, score_eval_fused_plain, score_plan)

    h, heads, cd, layers, convs, n, b = case
    ops = width_operands(dev, b, n, h, cd, layers, convs, variant, seed=h + n + variant)
    kw = dict(variant=variant, bf16=bf16, num_layers=layers, num_convs=convs, n_head=heads)
    with torch.no_grad():
        run_k = lambda: score_eval_fused(*ops, impl="kernel", **kw)  # noqa: E731
        run_p = lambda: score_eval_fused_plain(*ops, coff_dim=cd, **kw)  # noqa: E731
        out, ref = run_k(), run_p()
        again = run_k()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        rel = (out - ref).abs().max().item() / scale
        result = {"plan": score_plan(n, bf16, b=b, h=h, n_head=heads, coff_dim=cd,
                                     num_layers=layers, num_convs=convs,
                                     variant=variant)["plan"],
                  "max_rel_err": rel, "finite": bool(torch.isfinite(out).all()),
                  "same_bits": torch.equal(out, again), "ok": False}
        result["ok"] = result["finite"] and result["same_bits"] and rel <= TOL[bf16]
        if times:
            result["device_ms"] = device_ms(run_k, reps=2)
            result["plain_device_ms"] = device_ms(run_p, reps=2)
    return result


def profile_case(dev, case, bf16: bool, evals: int = 5) -> None:
    """K6's launches at one case by kernel name: device ms per evaluation."""
    from torch.profiler import ProfilerActivity, profile

    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.score_kernel import score_eval_fused

    h, heads, cd, layers, convs, n, b = case
    ops = width_operands(dev, b, n, h, cd, layers, convs, 1, seed=h + n + 1)
    kw = dict(bf16=bf16, num_layers=layers, num_convs=convs, n_head=heads)
    name = case_name(case, 1, bf16)
    with torch.no_grad():
        try:
            score_eval_fused(*ops, impl="kernel", **kw)
        except ValueError as e:
            print(f"{name}: refused ({e})", flush=True)
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(evals):
                score_eval_fused(*ops, impl="kernel", **kw)
            torch.cuda.synchronize()
    rows = sorted((a for a in prof.key_averages() if a.self_device_time_total > 0),
                  key=lambda a: -a.self_device_time_total)
    total = sum(a.self_device_time_total for a in rows) / evals / 1e3
    with torch.no_grad():
        graph_ms = device_ms(lambda: score_eval_fused(*ops, impl="kernel", **kw), reps=2)
    print(f"{name}: device_ms per evaluation {total:.4f} (profiler), {graph_ms:.4f} (CUDA-graph "
          f"replay)", flush=True)
    for a in rows:
        print(f"  {a.key[:60]}: {a.self_device_time_total / evals / 1e3:.4f} ms, "
              f"{a.count // evals} launches", flush=True)


def gat_phases(dev, case, bf16: bool) -> None:
    """The GAT pass's phases at one case (variant 1): the logits (e2 formed
    and kept, the heads' sums, the online softmax), the softmax's merge
    across the warp, the message and LayerNorm / FFN, by the
    ``%globaltimer`` stamps of a ``-DPHASE_PROFILE`` build of
    ``csrc/score_layered.cu`` (``timing.py``; the last GAT launch of an
    evaluation)."""
    import ctypes

    from moleculesde_tpu_torch.benchmarks.timing import (
        phase_library, phase_stamps, print_phase_stamps)
    from moleculesde_tpu_torch.ops.common import stream
    from moleculesde_tpu_torch.ops.score_kernel import score_param_layout, score_plan

    h, heads, cd, layers, convs, n, b = case
    lib = phase_library("score_layered")
    fn = lib.score_eval_layered
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    ops = [t.float().contiguous()
           for t in width_operands(dev, b, n, h, cd, layers, convs, 1, seed=h + n + 1)]
    layout, _ = score_param_layout(1, h, cd, layers, convs)
    offsets = (ctypes.c_int * len(layout))(*(o for _, _, o in layout))
    plan = score_plan(n, bf16, b=b, h=h, n_head=heads, coff_dim=cd, num_layers=layers,
                      num_convs=convs)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
    out = torch.empty(b, n, 3, device=dev)

    def launch():
        rc = fn(*(t.data_ptr() for t in ops), offsets, len(layout), out.data_ptr(),
                scratch.data_ptr(), b, n, 1, layers, convs, h, heads, cd, int(bf16),
                stream(ops[0]))
        assert rc == 0, rc

    print_phase_stamps(f"{case_name(case, 1, bf16)}: GAT pass",
                       phase_stamps(lib, b * -(-n // 8), 8, launch),
                       ["logits", "softmax merge", "message", "LayerNorm / FFN"])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--times", action="store_true", help="device times of each case")
    parser.add_argument("--profile", action="store_true",
                        help="launches by name at PROFILE_CASES, instead of the grid")
    parser.add_argument("--phases", action="store_true",
                        help="the GAT pass's phases at PROFILE_CASES, instead of the grid")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.profile or args.phases:
        for case in PROFILE_CASES:
            for bf16 in (True, False):
                (gat_phases if args.phases else profile_case)(dev, case, bf16)
        return 0
    failed = 0
    for case in WIDTH_GRID:
        for variant in (1, 2):
            for bf16 in (False, True):
                r = check_case(dev, case, variant, bf16, args.times)
                failed += not r["ok"]
                extra = (f" device_ms={r['device_ms']:.4f} plain_device_ms="
                         f"{r['plain_device_ms']:.4f}" if args.times else "")
                print(f"{case_name(case, variant, bf16)}: plan {r['plan']} max_rel_err="
                      f"{r['max_rel_err']:.3e} (bar {TOL[bf16]:g}) same_bits={r['same_bits']}"
                      f"{extra}{'' if r['ok'] else ' FAIL'}", flush=True)
    print(f"{failed} of {len(WIDTH_GRID) * 4} cases failed on {torch.cuda.get_device_name(0)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
