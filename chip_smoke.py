#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases card,kernels   # a subset, for bring-up

Phases:

1. card: the card's name and power limit, the torch and CUDA versions, TF32
   off for matmuls and cuDNN, and the build of the CUDA kernels from the
   sources in this checkout (``distributed_optimization_tpu_torch/csrc``).
2. kernels: each ring kernel against its plain PyTorch version on the card,
   at the main path's shape (N=256, d=81) and at N=4096, d=1024, in float32
   and float64: the largest difference (must be within 1 ulp), the median
   time of 200 launches from CUDA events, the plain version's time, one
   PyTorch library call computing the same function (``torch.matmul`` or
   ``torch.addmm`` with the dense MH matrix) and the bytes-or-operations
   bound.
3. reference: a small float64 run on the card (fused ring kernel) against
   the same run on the CPU (plain versions): the gap histories must agree
   to 1e-12, since the counter-based sampler gives both the same batches.
4. parity: the reference study's N=25 ring (logistic, T=10,000, float32,
   ``mixing_impl='pallas'``) must reach ε=0.08 within T; the fused kernel
   must launch exactly T times.
5. main: the N=256 ring (dense-weights sampling, eval every iteration,
   T=40,000) with ``mixing_impl='pallas'`` and with ``'stencil'``; each must
   stay finite, cross ε=0.08 within T and end with consensus below 1.0.
   The fused kernel's launches are counted over the pallas run alone.
6. mixing: the pallas ``MixingOp`` (``ring_mix``, ``ring_neighbor_sum``)
   applied to the main run's final models, against the dense W and A; its
   launches are counted over this phase alone.

On request, ``profile`` traces 300 iterations of the main path with
``torch.profiler`` and prints the device's busy share, the device
operations per iteration and the kernels that take the most device time.

The line before the last is the JSON ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
and prints no result line. Without a card it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

PHASES = ("card", "kernels", "reference", "parity", "main", "mixing")
# Run only when asked for (--phases ...,profile): a torch.profiler trace of
# the main path's steady loop.
OPTIONAL_PHASES = ("profile",)

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

MAIN_SHAPE = (256, 81)
# The main path's T: past the ε=0.08 crossing near 22,500 iterations that the
# JAX package recorded, cut from bench.py's 300,000 to keep the run short.
MAIN_ITERATIONS = 40_000
SHAPES = (MAIN_SHAPE, (4096, 1024))
TIMED_LAUNCHES = 200
KERNEL_SOURCE = "distributed_optimization_tpu_torch/csrc/ring_kernels.cu"
REPLACES = {
    "fused_ring_dsgd_step": "distributed_optimization_tpu/ops/pallas_kernels.py:143",
    "ring_mix": "distributed_optimization_tpu/ops/pallas_kernels.py:137",
    "ring_neighbor_sum": "distributed_optimization_tpu/ops/pallas_kernels.py:177",
}
# Floating-point operations per element of the [N, d] output.
OPS_PER_ELEMENT = {"fused_ring_dsgd_step": 4, "ring_mix": 3, "ring_neighbor_sum": 1}


class PhaseFailed(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def time_ms(torch, fn, n: int = TIMED_LAUNCHES) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, from CUDA
    event pairs. A sleep kernel first holds the stream, so the host queues
    every call before the card starts them and host gaps stay out."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(name: str, n: int, d: int, dtype_name: str, itemsize: int):
    """(ms, 'bytes' or 'operations'): each input read once, the output
    written once, over the memory rate; the operations over the peak."""
    arrays = 3 if name == "fused_ring_dsgd_step" else 2
    nbytes = arrays * n * d * itemsize + (itemsize if name == "fused_ring_dsgd_step" else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT[name] * n * d / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card(torch, rk):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(f"[card] {smi}")
    say(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("[card] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    path = rk.build()
    say(f"[card] built {path.name} from {KERNEL_SOURCE} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(rk.NVCC_FLAGS)})")
    return smi


def _calls(torch, rk, name, x, g, eta, W, A):
    """(kernel call, plain call, library call) for one kernel."""
    if name == "fused_ring_dsgd_step":
        eta_f = float(eta.item())
        return (lambda: rk.fused_ring_dsgd_step(x, g, eta),
                lambda: rk.fused_ring_dsgd_step_plain(x, g, eta),
                lambda: torch.addmm(g, W, x, beta=-eta_f, alpha=1.0))
    if name == "ring_mix":
        return (lambda: rk.ring_mix(x), lambda: rk.ring_mix_plain(x),
                lambda: torch.matmul(W, x))
    return (lambda: rk.ring_neighbor_sum(x), lambda: rk.ring_neighbor_sum_plain(x),
            lambda: torch.matmul(A, x))


def phase_kernels(torch, rk, topology):
    """Returns {kernel: record} at the main path's shape in float32."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d in SHAPES:
        topo = topology.build_topology("ring", n)
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            x = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
            g = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
            eta = torch.tensor([0.05 / 7.0], dtype=dtype, device="cuda")
            W = torch.as_tensor(topo.mixing_matrix, dtype=dtype, device="cuda")
            A = torch.as_tensor(topo.adjacency, dtype=dtype, device="cuda")
            for name in rk.KERNELS:
                kernel, plain, library = _calls(torch, rk, name, x, g, eta, W, A)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                diff = (got - want).abs()
                ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
                err = float(diff.max())
                check(bool(torch.all(diff <= ulp)),
                      f"{name} N={n} d={d} {dname}: more than 1 ulp from its plain version "
                      f"(max abs diff {err:.3e})")
                ms, plain_ms, lib_ms = time_ms(torch, kernel), time_ms(torch, plain), time_ms(torch, library)
                b_ms, b_by = bound(name, n, d, dname, x.element_size())
                say(f"[kernels] {name:22s} N={n:5d} d={d:5d} {dname}: max_abs_err {err:.3e} "
                    f"kernel {ms * 1e3:9.3f} us  plain {plain_ms * 1e3:9.3f} us  "
                    f"library {lib_ms * 1e3:9.3f} us  bound {b_ms * 1e3:8.4f} us ({b_by})")
                if (n, d) == MAIN_SHAPE and dtype == torch.float32:
                    records[name] = {
                        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms,
                    }
    say(f"[kernels] ported kernels: {', '.join(rk.KERNELS)}")
    return records


def phase_reference(torch, pkg):
    cfg = pkg.ExperimentConfig(
        problem_type="logistic", n_workers=8, n_samples=400, n_features=10,
        n_informative_features=6, n_iterations=200, local_batch_size=8,
        mixing_impl="pallas", sampling_impl="dense", dtype="float64",
    )
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    card = pkg.run(cfg, ds, f_opt, device="cuda")
    host = pkg.run(cfg, ds, f_opt, device="cpu")
    diff = float(abs(card.history.objective - host.history.objective).max())
    models = float(abs(card.final_models - host.final_models).max())
    say(f"[reference] N=8 T=200 float64 pallas on the card vs plain on the CPU: "
        f"max gap diff {diff:.3e}, max model diff {models:.3e}")
    check(diff <= 1e-12 and models <= 1e-12, "card and CPU runs disagree beyond 1e-12")


def _converging_run(torch, pkg, rk, cfg, ds, f_opt, label):
    rk.reset_launch_counts()
    res = pkg.run(cfg, ds, f_opt, device="cuda")
    launches = dict(rk.LAUNCHES)
    h = res.history
    crossed = pkg.iterations_to_threshold(h.objective, cfg.suboptimality_threshold,
                                          h.eval_iterations)
    say(f"[{label}] N={cfg.n_workers} T={cfg.n_iterations} {cfg.mixing_impl}: "
        f"iters-to-{cfg.suboptimality_threshold} = {crossed}, final gap {h.objective[-1]:.6f}, "
        f"consensus {h.consensus_error[-1]:.3e}, {h.iters_per_second:.1f} iters/s "
        f"(warm-up {h.compile_seconds:.2f} s), kernel launches {launches}")
    import numpy as np

    check(h.objective.shape == (cfg.n_iterations // cfg.eval_every,), "gap history has the wrong shape")
    check(bool(np.all(np.isfinite(h.objective))), "non-finite gaps")
    check(0 < crossed <= cfg.n_iterations,
          f"never reached ε={cfg.suboptimality_threshold} within T={cfg.n_iterations}")
    return res, launches


def phase_parity(torch, pkg, rk):
    cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                               mixing_impl="pallas", dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    _, launches = _converging_run(torch, pkg, rk, cfg, ds, f_opt, "parity")
    say("[parity] reference Table I: 9927 iterations")
    check(launches["fused_ring_dsgd_step"] == cfg.n_iterations,
          f"fused kernel launched {launches['fused_ring_dsgd_step']} times, not T")


def phase_main(torch, pkg, rk, T):
    cfg = pkg.ExperimentConfig(problem_type="logistic", algorithm="dsgd", topology="ring",
                               n_workers=256, n_iterations=T, mixing_impl="pallas",
                               dtype="float32", eval_every=1)
    ds = pkg.generate_synthetic_dataset(cfg)
    _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
    runs = {}
    launches = None
    for impl in ("pallas", "stencil"):
        res, counted = _converging_run(torch, pkg, rk, cfg.replace(mixing_impl=impl),
                                       ds, f_opt, "main")
        check(float(res.history.consensus_error[-1]) < 1.0, "consensus error not below 1.0")
        runs[impl] = res
        if impl == "pallas":
            launches = counted
            check(counted["fused_ring_dsgd_step"] == T,
                  f"fused kernel launched {counted['fused_ring_dsgd_step']} times, not T={T}")
    gap_diff = float(abs(runs["pallas"].history.objective - runs["stencil"].history.objective).max())
    say(f"[main] sampling dense (L={max(len(s) for s in ds.shard_indices)}), T={T}: "
        f"largest |gap(pallas) - gap(stencil)| = {gap_diff:.3e}")
    return runs["pallas"], launches


def phase_mixing(torch, pkg, rk, final_models):
    topo = pkg.build_topology("ring", final_models.shape[0])
    op = pkg.make_mixing_op(topo, "pallas")
    x = torch.as_tensor(final_models, dtype=torch.float32, device="cuda").contiguous()
    rk.reset_launch_counts()
    mixed, summed = op.apply(x), op.neighbor_sum(x)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    import numpy as np

    x64 = x.double().cpu().numpy()
    err_w = float(np.abs(mixed.double().cpu().numpy() - topo.mixing_matrix @ x64).max())
    err_a = float(np.abs(summed.double().cpu().numpy() - topo.adjacency @ x64).max())
    scale = float(np.abs(x64).max())
    say(f"[mixing] MixingOp(pallas) on the N={x.shape[0]} final models: "
        f"|Wx - dense| {err_w:.3e}, |Ax - dense| {err_a:.3e} (max |x| {scale:.3e}), "
        f"launches {launches}")
    check(err_w <= 1e-6 * max(scale, 1.0) and err_a <= 2e-6 * max(scale, 1.0),
          "MixingOp(pallas) disagrees with the dense W/A beyond float32 rounding")
    return launches


def phase_profile(torch, pkg, T: int = 300):
    from torch.profiler import ProfilerActivity, profile

    for impl in ("pallas", "stencil"):
        cfg = pkg.ExperimentConfig(problem_type="logistic", n_workers=256, n_iterations=T,
                                   mixing_impl=impl, dtype="float32", eval_every=1)
        ds = pkg.generate_synthetic_dataset(cfg)
        _, f_opt = pkg.compute_reference_optimum(ds, cfg.reg_param)
        pkg.run(cfg, ds, f_opt, device="cuda")  # warm: kernels built, caches filled
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = pkg.run(cfg, ds, f_opt, device="cuda")
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        check(len(device) > 0, "the profiler recorded no device activity")
        start = min(e.time_range.start for e in device)
        end = max(e.time_range.end for e in device)
        busy = sum(e.time_range.elapsed_us() for e in device)
        by_name = {}
        for e in device:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        say(f"[profile] N=256 {impl} T={T}: {len(device) / T:.1f} device ops/iteration, "
            f"device busy {busy / (end - start):.3f} of {(end - start) / T:.1f} us/iteration "
            f"({busy / T:.1f} us busy), {res.history.iters_per_second:.1f} iters/s under the profiler")
        for name, (total, count) in top:
            say(f"[profile]   {total / T:8.2f} us/iteration  {count / T:5.1f}/iteration  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from distributed_optimization_tpu_torch.ops import ring_kernels as rk
    from distributed_optimization_tpu_torch.parallel import topology
    pkg = _package()

    t_start = time.perf_counter()
    phase_card(torch, rk)
    records = {}
    if "kernels" in phases:
        records = phase_kernels(torch, rk, topology)
    if "reference" in phases:
        phase_reference(torch, pkg)
    if "parity" in phases:
        phase_parity(torch, pkg, rk)
    main_launches = mixing_launches = None
    if "main" in phases:
        main_res, main_launches = phase_main(torch, pkg, rk, MAIN_ITERATIONS)
        if "mixing" in phases:
            mixing_launches = phase_mixing(torch, pkg, rk, main_res.final_models)

    if "profile" in phases:
        phase_profile(torch, pkg)

    if records:
        paths = {
            "fused_ring_dsgd_step": (main_launches, "main: dsgd, ring, N=256, mixing_impl=pallas"),
            "ring_mix": (mixing_launches, "mixing: MixingOp(pallas).apply"),
            "ring_neighbor_sum": (mixing_launches, "mixing: MixingOp(pallas).neighbor_sum"),
        }
        kernels = []
        for name in rk.KERNELS:
            counted, path = paths[name]
            kernels.append({**records[name],
                            "launches": None if counted is None else counted[name],
                            "path": path})
        if main_launches is not None and mixing_launches is not None:
            check(all(k["launches"] > 0 for k in kernels),
                  "a ported kernel was not launched on its path")
        say(json.dumps({"kernels": kernels}))
    say(f"[done] phases {','.join(phases)} in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _package():
    """The port's entry points, gathered into one namespace."""
    import types

    from distributed_optimization_tpu_torch.backends.torch_backend import run
    from distributed_optimization_tpu_torch.config import ExperimentConfig
    from distributed_optimization_tpu_torch.metrics import iterations_to_threshold
    from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
    from distributed_optimization_tpu_torch.parallel.topology import build_topology
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    return types.SimpleNamespace(
        run=run, ExperimentConfig=ExperimentConfig,
        iterations_to_threshold=iterations_to_threshold, make_mixing_op=make_mixing_op,
        build_topology=build_topology, generate_synthetic_dataset=generate_synthetic_dataset,
        compute_reference_optimum=compute_reference_optimum,
    )


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
