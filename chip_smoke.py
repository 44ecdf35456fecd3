#!/usr/bin/env python3
"""The port's proof that it starts on the GPU: ``python3 chip_smoke.py``.

Drives ``dptpu_torch`` — and nothing of ``dptpu`` or JAX — on one CUDA
card, in phases; any phase that fails exits nonzero:

1. device: a CUDA card is present; print its name and power limit as
   ``nvidia-smi`` gives them;
2. build: compile every kernel from ``dptpu_torch/csrc`` (nvcc, sm_90a,
   one process per source);
3. kernels vs plain: each kernel against its plain PyTorch version on
   the card at every shape the slices give it and at small and
   tie-heavy ones, f32 and bf16, negative gammas — the forward's ``y``
   and the backward's ``dz`` BITWISE, the backward's dgamma_t/dbeta_t
   within rtol 1e-5, atol 1e-4, and two backward launches bitwise equal
   to each other; each also at the shapes and layouts that reach its
   other code paths (``FWD_PATH_CASES``, with gamma/beta in f32 and in
   bf16, and ``BWD_PATH_CASES``: channel tails, the scalar
   instantiation, planes no multiple of the tile, a misaligned z, a
   strided g). The forward at every slice shape (the train stem, serve
   exec batches 64, 16, 4 and 2) prints two lines: ``kernel ...`` with
   the kernel's device time (50 launches in one CUDA graph, replayed
   between CUDA events) beside its memory bound, and ``host ...`` with
   the wrapper's host time a call (``perf_counter`` over queued calls);
   below exec 16 the host's time is the longer. The backward is timed
   by CUDA events over queued launches (median of windows). Each kernel
   prints its registers, shared memory, occupancy and achieved rate at
   the train stem; the phase prints, as
   information, the whole train-mode stem module forward and backward at
   the train stem — the fused ``FusedBNReLUPool`` (batch statistics,
   both kernels) against the unfused BN -> ReLU -> max-pool the model
   otherwise runs — under the train slice's bf16 autocast and in f32;
4. layout probes: the ten kernels of ``scripts/probe_mosaic*.py``
   (``dptpu_torch/ops/layout_probes.py``), each bitwise equal to its
   plain version at the scripts' shapes, at ragged ones and at the train
   stem's size in f32; the grid accumulator within rtol 1e-6 of an f64
   sum and the same on two launches; each timed beside its byte bound,
   its plain version and the one PyTorch call that computes the same
   function, kernel and call in a paired A/B (20 ABBA alternations of
   their windows: medians, the median paired difference, its IQR and
   extremes, and the verdict). Then the tooling path: ``python -m
   dptpu_torch.tools.probe_mosaic``, ``probe_mosaic2`` and
   ``stem_bench`` on the card, each exiting 0, the probe tools launching
   each kernel once (their printed counters); ``stem_bench``'s
   fused-vs-stock stem function times are printed as information;
5. the serve slice: ``python -m dptpu_torch serve -a resnet50 --buckets
   1,4,16,64 --selftest 64`` with ``DPTPU_FUSED_STEM=1`` from a seeded
   random init — every request served, every forward through the fused
   stem kernel (its launch counter, zeroed just before);
6. serve outputs: ResNet-50 logits of the fused-stem engine against the
   unfused one (same weights, same uint8 batch), against the plain CPU
   path, and bucket 1 against bucket 16 (printed, not gated);
7. the train slice: ``python -m dptpu_torch train synthetic:1280 -a
   resnet50 -b 128 --epochs 1 --opt-level O2`` with ``DPTPU_FUSED_STEM=1``
   from seed 0 — every loss finite, the backward kernel launched once per
   train step and the forward once per train step and val batch (the
   counters, zeroed just before); prints the steady-state img/s;
8. training outputs: one fp32 ResNet-50 step at 224, batch 8, TF32 off,
   from zero_init_residual weights, fused vs unfused stem and card vs the
   plain CPU path — loss within 1e-5 relative, every gradient leaf within
   1e-3 of its max|grad|; prints the same step's 1-ulp floor;
9. one JSON line with the kernel table (the stem kernels' launches are
   the train path's; the probes', launched on no serve or train path,
   are the tool runs'), then the ``{"ok": true, ...}`` line.

Run from the repository root; it exits nonzero without a card, and in a
directory that holds nothing of the repository but this file.

``python3 chip_smoke.py --parent DIR`` runs, instead of the phases above,
the forward kernel against the one in DIR (a tree of the parent commit,
e.g. ``git archive <commit>`` unpacked there): one worker process a tree,
each on its own ``dptpu_torch``, asked in turns (20 ABBA pairs) for the
kernel's device time at the train stem (bf16) and serve exec 64 (f32)
and for the wrapper's host time a call at exec 2 (f32 and bf16), after a
check that both give the same ``y`` bit for bit. It prints the medians,
the median paired difference, its IQR and extremes, and the verdict.
"""

from __future__ import annotations

import contextlib
import json
import os
import select
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the train slice's stem: ResNet-50 at 224, batch 128
TRAIN_STEM = (128, 112, 112, 64)
# max|Δlogit| / max|logit| allowed between the fused and the unfused stem:
# the fused stem folds the BN statistics into one affine (a <= 1 ulp
# change per stem activation); the CPU tests measure the same ratio
# (tests/test_torch_resnet.py, FUSED_VS_UNFUSED_REL)
FUSED_VS_UNFUSED_REL = 1e-5
# the card's cuDNN/cuBLAS sum in other orders than the CPU's oneDNN: fp32
# logits agree to a few ulp of their scale, not bitwise (the CPU tests
# hold the port to JAX at the same ratio, PORT_VS_JAX_REL)
GPU_VS_CPU_REL = 1e-5
# one fp32 training step, fused vs unfused stem and card vs CPU: the loss
# within STEP_LOSS_REL relative, every gradient leaf within STEP_GRAD_REL
# of that leaf's max|grad|. The step starts from torchvision's
# zero_init_residual weights (each bottleneck's last BN scale 0): from the
# plain seeded init, moving conv1's weights by 1 ulp moves this step's
# gradients by 2.8% (relative L2; 21% element-wise), so no 1e-3 gate can
# hold between two right implementations; with the residual branches at
# zero the same 1-ulp change moves them 3.9e-5 (L2), 5.0e-4 element-wise.
# The script prints that floor beside the gates on every run.
STEP_LOSS_REL = 1e-5
STEP_GRAD_REL = 1e-3
# the backward's affine grads against the plain version: the JAX test's
# own tolerance (tests/test_fused_stem.py); only the summation order
# differs
BWD_RTOL, BWD_ATOL = 1e-5, 1e-4
# the layout probes' shapes, per script layout: the script's own, a small
# ragged one, and the train stem's size in f32 (411 MB)
PROBE_SHAPES = {
    "probe_mosaic": ((16, 16, 2, 128), (6, 10, 2, 8), (112, 112, 2, 4096)),
    "probe_mosaic2": ((2, 16, 16, 64), (1, 6, 10, 8), (128, 112, 112, 64)),
}
# the grid accumulator (summed in f64, rounded once) against an f64 sum
ACCUM_RTOL = 1e-6
# kernel vs library windows in each probe's paired A/B
PAIRS = 20
# the tooling path's subprocesses: a process reaches the card in ~8 s
TOOL_TIMEOUT_S = 300


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 25, per_window: int = 10) -> float:
    """Device time of one call: CUDA events around ``per_window`` calls
    queued back to back (so the host's per-call overhead hides behind the
    device's work wherever the device is the slower side), divided by
    ``per_window``; the median over ``reps`` windows."""
    from dptpu_torch.tools import time_ms as cuda_time_ms

    return cuda_time_ms(fn, reps, per_window)


def paired(sample_a, sample_b) -> dict:
    """The repository's paired A/B: ``PAIRS`` alternations of one sample
    of ``sample_a`` and one of ``sample_b`` (each a callable returning a
    number), the order flipped from pair to pair (ABBA) so that a drift of
    the card's clock cancels in the median. Returns the median of each
    side (``a_ms``, ``b_ms``) and of the paired differences a - b
    (``delta_ms``), with the differences' quartiles (``q1``, ``q3``) and
    extremes, in the samples' unit."""
    a, b = [], []
    for i in range(PAIRS):
        if i % 2:
            b.append(sample_b())
            a.append(sample_a())
        else:
            a.append(sample_a())
            b.append(sample_b())
    d = [x - y for x, y in zip(a, b)]
    q1, _, q3 = statistics.quantiles(d, n=4)
    return {"a_ms": statistics.median(a), "b_ms": statistics.median(b),
            "delta_ms": statistics.median(d), "q1": q1, "q3": q3,
            "min": min(d), "max": max(d)}


def paired_ms(fn_a, fn_b) -> dict:
    """:func:`paired` of one ``time_ms`` window of ``fn_a`` and one of
    ``fn_b``, in ms."""
    return paired(lambda: time_ms(fn_a), lambda: time_ms(fn_b))


def paired_verdict(p: dict, other: str = "the library call") -> str:
    """A kernel against ``other``, from their paired differences: faster
    or slower only where the interquartile range of the differences lies
    wholly on one side of 0."""
    if p["q3"] < 0:
        return f"faster than {other} (the IQR lies below 0)"
    if p["q1"] <= 0:
        return f"no slower than {other} within the spread (the IQR holds 0)"
    return f"slower than {other} (the IQR lies above 0)"


def stem_bound_ms(shape, itemsize: int) -> float:
    """Least time for the fused stem forward: read z once, write y once,
    read gamma/beta once, at the card's memory rate (it does ~13 flops
    per output element — bytes bind, not operations). At the train stem
    in bf16, [128,112,112,64]: 256.9 MB, 76.7 us."""
    b, h, w, c = shape
    nbytes = (b * h * w * c + b * ((h + 1) // 2) * ((w + 1) // 2) * c) \
        * itemsize + 2 * c * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def stem_bwd_bound_ms(shape, itemsize: int) -> float:
    """Least time for the fused stem backward: read z and g once, write dz
    once (and the [C] vectors), at the card's memory rate (~30 flops per z
    element: bytes bind). At the train stem, [128,112,112,64]: bf16
    205.5 + 51.4 + 205.5 MB = 462.4 MB, 138.0 us; f32 924.8 MB, 276.1 us."""
    b, h, w, c = shape
    nbytes = (2 * b * h * w * c + b * ((h + 1) // 2) * ((w + 1) // 2) * c) \
        * itemsize + 4 * c * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})", flush=True)


def phase_build():
    from dptpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {build.last_build_seconds:.2f}s)", flush=True)


def _stem_case(rng, shape, dtype, device="cuda"):
    """Seeded gamma (every fifth one negative: it flips the window's
    order) and beta on the card, in the dtype the model passes them."""
    import torch

    c = shape[-1]
    gam = rng.randn(c) * 0.5 + 1.0
    gam[::5] *= -1.0
    gamma = torch.tensor(gam, dtype=torch.float32, device=device)
    beta = torch.tensor(rng.randn(c) * 0.1, dtype=torch.float32,
                        device=device)
    return gamma.to(dtype), beta.to(dtype)


# the forward's slice shapes: the train stem (batch 128) and the serve
# stem at each exec batch of buckets 1/4/16/64 (1 runs padded to 2)
FWD_SLICE_SHAPES = [(n, 112, 112, 64) for n in (128, 64, 16, 4, 2)]
SERVE_EXEC64 = (64, 112, 112, 64)
# shapes that reach the forward kernel's other code paths, gated and not
# timed, each with gamma/beta in f32 and in bf16: channel counts that leave
# a vector tail or take the scalar instantiation, pooled planes that are no
# multiple of its 8 x 8 tile (and odd ones), and z one element past a
# 16-byte boundary ("offset"), which takes the scalar instantiation
FWD_PATH_CASES = (
    ((2, 18, 18, 3), None), ((2, 18, 18, 8), None), ((2, 18, 18, 24), None),
    ((2, 18, 18, 72), None), ((3, 114, 114, 64), None),
    ((2, 30, 226, 64), None), ((2, 7, 9, 64), None), ((1, 7, 9, 64), None),
    ((2, 8, 8, 64), None), ((2, 32, 32, 64), None),
    ((2, 18, 18, 64), "offset"),
)
# the calls a CUDA graph of the forward holds for its device time, and the
# queued calls of a host-time sample
GRAPH_CALLS = 50
HOST_CALLS = 200


def graph_device_us(fn, calls: int = GRAPH_CALLS, reps: int = 7) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed between CUDA events, so no host time falls
    between the launches; the median over ``reps`` replays, divided by
    ``calls``. The graph's own gap between two dependent launches stays
    in (it shows at the smallest sizes only). ``torch.profiler``'s kernel
    records would leave that gap out, but on an H100 under torch 2.11
    they dropped launches' records, up to all of a window's."""
    import torch

    side = torch.cuda.Stream()  # warm-up off the default stream, as
    side.wait_stream(torch.cuda.current_stream())  # capture wants it
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def host_us(fn, calls: int = HOST_CALLS, reps: int = 7) -> float:
    """Host time of one call of ``fn``: ``perf_counter`` around ``calls``
    calls queued back to back, stopped before the device is waited on,
    with the garbage collector off as ``timeit`` runs; the median over
    ``reps`` samples."""
    import gc

    import torch

    fn()
    times = []
    gc.disable()
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return statistics.median(times)


def _fwd_layout(z, layout):
    """``z`` copied one element past its allocation's start for the
    "offset" case, else ``z``."""
    import torch

    if layout == "offset":
        flat = torch.empty(z.numel() + 1, dtype=z.dtype, device=z.device)
        shifted = flat[1:].view(z.shape)
        shifted.copy_(z)
        return shifted
    return z


def _fwd_gate(z, gamma, beta, what: str, bits) -> float:
    """The forward kernel against its plain version on ``z``: bitwise,
    same shape and dtype. Returns max|Δ| (0 when it passes)."""
    import torch

    from dptpu_torch.ops.fused_stem import (
        affine_relu_pool_forward,
        affine_relu_pool_plain,
    )

    y = affine_relu_pool_forward(z, gamma, beta)
    y_ref = affine_relu_pool_plain(z, gamma, beta)
    torch.cuda.synchronize()
    check(y.shape == y_ref.shape and y.dtype == y_ref.dtype,
          f"{what}: kernel gives {tuple(y.shape)} {y.dtype}, plain "
          f"{tuple(y_ref.shape)} {y_ref.dtype}")
    err = (y.float() - y_ref.float()).abs().max().item()
    check(torch.equal(y.view(bits), y_ref.view(bits)),
          f"{what}: kernel differs from the plain version (max|Δ| {err})")
    return err


def fwd_host_parts(z, gamma, beta) -> dict:
    """The forward wrapper's host time a call at ``z``'s shape
    (:func:`host_us`), and its parts: allocating y, the C entry with its
    kernel launch, and the C entry alone (an empty batch returns before it
    launches). What is left is the wrapper's Python: checks and
    bookkeeping."""
    from dptpu_torch.ops import fused_stem

    y = fused_stem.affine_relu_pool_forward(z, gamma, beta)
    fns = fused_stem._kernels()
    index = z.get_device()
    vcode = fused_stem._DTYPE_CODES[gamma.dtype]
    args = [fused_stem._DTYPE_CODES[z.dtype], int(fused_stem.vectorized(z, y)),
            vcode, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), *z.shape, fns.stream(index)]
    empty = args[:7] + [0] + args[8:]
    return {
        "wrapper": host_us(
            lambda: fused_stem.affine_relu_pool_forward(z, gamma, beta)),
        "alloc": host_us(lambda: z.new_empty(y.shape)),
        "entry_launch": host_us(lambda: fns.fwd(*args)),
        "entry": host_us(lambda: fns.fwd(*empty)),
    }


def phase_forward_kernel():
    """Fused stem forward kernel vs its plain version, bitwise, at every
    shape the slices give it (the train stem of batch 128, the serve stem
    of exec batches 64, 16, 4 and 2, all at 224) and at the cases of
    ``FWD_PATH_CASES``, f32 and bf16, randn and tie-heavy inputs, negative
    gammas. At each slice shape it prints the kernel's device time
    (a CUDA graph of launches) and, on a line of its own, the wrapper's
    host time a call; at the train stem the kernel's registers, occupancy and
    achieved rate. Returns the train-stem bf16 row of the kernel table,
    with the serve exec-64 f32 time."""
    import torch

    from dptpu_torch.ops.fused_stem import (
        affine_relu_pool_forward,
        affine_relu_pool_plain,
        forward_kernel_attrs,
        vectorized,
    )

    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {}
    max_err = 0.0
    for dtype, itemsize, bits in ((torch.float32, 4, torch.int32),
                                  (torch.bfloat16, 2, torch.int16)):
        name = str(dtype)[6:]
        for shape in FWD_SLICE_SHAPES:
            gamma, beta = _stem_case(rng, shape, dtype)
            zs = torch.randn(shape, device="cuda", generator=gen)
            launches0 = affine_relu_pool_forward.launches
            for kind, zn in (("randn", zs), ("ties", torch.round(zs * 2) / 2)):
                z = zn.to(dtype)
                max_err = max(max_err, _fwd_gate(
                    z, gamma, beta, f"fused stem {name} {shape} {kind}", bits))
            path = "vectorized" if vectorized(z) else "scalar-channel"

            def fwd():
                return affine_relu_pool_forward(z, gamma, beta)

            device_ms = graph_device_us(fwd) / 1e3
            ms = time_ms(fwd)
            host = host_us(fwd)
            plain_ms = time_ms(lambda: affine_relu_pool_plain(z, gamma, beta))
            bound = stem_bound_ms(shape, itemsize)
            print(f"kernel fused_stem_fwd {name} {list(shape)}: bitwise "
                  f"equal to plain (randn + ties, negative gamma; {path} "
                  f"instantiation); device {device_ms * 1e3:.1f} us a launch "
                  f"({GRAPH_CALLS} launches in a CUDA graph), bound "
                  f"{bound * 1e3:.2f} us ({bound / device_ms:.1%} of bound); "
                  f"queued-window time {ms * 1e3:.1f} us, plain "
                  f"{plain_ms * 1e3:.1f} us; launches in this check and its "
                  f"timing {affine_relu_pool_forward.launches - launches0}",
                  flush=True)
            print(f"host fused_stem_fwd {name} {list(shape)}: "
                  f"{host:.1f} us of host time a wrapper call (perf_counter "
                  f"over {HOST_CALLS} queued calls, median of 7)", flush=True)
            if shape[0] == 2:
                parts = fwd_host_parts(z, gamma, beta)
                rest = (parts["wrapper"] - parts["alloc"]
                        - parts["entry_launch"])
                print(f"host fused_stem_fwd {name} {list(shape)} parts: "
                      f"wrapper {parts['wrapper']:.1f} us = allocating y "
                      f"{parts['alloc']:.1f} + C entry with its launch "
                      f"{parts['entry_launch']:.1f} (the entry alone "
                      f"{parts['entry']:.1f}) + checks and bookkeeping "
                      f"{rest:.1f}", flush=True)
            if dtype is torch.bfloat16 and shape == TRAIN_STEM:
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound)
                attrs = forward_kernel_attrs(dtype, True, shape[-1])
                print(f"kernel fused_stem_fwd {name} {list(shape)} "
                      f"vectorized instantiation: {attrs['registers']} "
                      f"registers a thread, {attrs['local_bytes']} local "
                      f"(spill) bytes a thread, {attrs['shared_bytes']} "
                      f"shared bytes and {attrs['threads']} threads a block, "
                      f"{attrs['blocks_per_sm']} resident blocks an SM; "
                      f"achieved {bound * HBM_BYTES_PER_S / device_ms / 1e9:.1f}"
                      f" GB/s of the {HBM_BYTES_PER_S / 1e9:.0f} GB/s bound",
                      flush=True)
            if dtype is torch.float32 and shape == SERVE_EXEC64:
                row.update(serve_exec64_f32_ms=ms,
                           serve_exec64_f32_bound_ms=bound)
        for shape, layout in FWD_PATH_CASES:
            zs = torch.randn(shape, device="cuda", generator=gen)
            for vdtype in (torch.float32, torch.bfloat16):
                gamma, beta = _stem_case(rng, shape, vdtype)
                for kind, zn in (("randn", zs),
                                 ("ties", torch.round(zs * 2) / 2)):
                    z = _fwd_layout(zn.to(dtype), layout)
                    max_err = max(max_err, _fwd_gate(
                        z, gamma, beta,
                        f"fused stem {name} {shape}"
                        f"{f' ({layout})' if layout else ''} {kind}, "
                        f"gamma/beta {str(vdtype)[6:]}", bits))
            path = "vectorized" if vectorized(z) else "scalar-channel"
            print(f"kernel fused_stem_fwd {name} {list(shape)}"
                  f"{f' ({layout})' if layout else ''}: bitwise equal to "
                  f"plain (randn + ties, negative gamma, gamma/beta in f32 "
                  f"and in bf16; {path} instantiation; not timed)",
                  flush=True)
    row["max_abs_err"] = max_err
    return row


# the comparison with the parent commit's forward (``--parent DIR``):
# (label, shape, dtype, what is timed) — the kernel's device time where
# the kernel is long, the wrapper's host time where the host binds
PARENT_CASES = (
    ("train stem", TRAIN_STEM, "bfloat16", "device"),
    ("serve exec 64", SERVE_EXEC64, "float32", "device"),
    ("serve exec 2", (2, 112, 112, 64), "float32", "host"),
    ("serve exec 2", (2, 112, 112, 64), "bfloat16", "host"),
)
# seconds a worker of the parent comparison may take to answer a request
AB_ANSWER_S = 120


def ab_worker(tree: str):
    """``chip_smoke.py --ab-worker TREE``: one side of the parent
    comparison, run on TREE's own ``dptpu_torch``. For each request line
    ``{"shape", "dtype", "what"}`` it calls TREE's forward wrapper on z,
    gamma and beta made on the card from seed 5 (the same bits in every
    tree; gamma/beta in z's dtype, as the model passes them) and answers
    one JSON line: one ``time_ms`` window in ms (``"device"``), one
    :func:`host_us` sample in µs (``"host"``), or the SHA-256 of y's bytes
    (``"digest"``)."""
    import hashlib

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from dptpu_torch.ops import fused_stem

    check(fused_stem.__file__.startswith(tree + os.sep),
          f"--ab-worker {tree}: imported {fused_stem.__file__}")
    from dptpu_torch.kernels.build import load_library

    load_library()
    print(json.dumps({"ready": tree}), flush=True)
    inputs = {}
    for line in sys.stdin:
        req = json.loads(line)
        shape, dtype = tuple(req["shape"]), getattr(torch, req["dtype"])
        if (shape, dtype) not in inputs:
            gen = torch.Generator(device="cuda").manual_seed(5)
            z = torch.randn(shape, device="cuda", generator=gen)
            gamma = torch.randn(shape[-1], device="cuda", generator=gen)
            beta = torch.randn(shape[-1], device="cuda", generator=gen)
            inputs[shape, dtype] = (z.to(dtype), (gamma * 0.5 + 1).to(dtype),
                                    (beta * 0.1).to(dtype))
        z, gamma, beta = inputs[shape, dtype]

        def fwd():
            return fused_stem.affine_relu_pool_forward(z, gamma, beta)

        if req["what"] == "device":
            value = time_ms(fwd)
        elif req["what"] == "host":
            value = host_us(fwd)
        else:
            value = hashlib.sha256(
                fwd().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        print(json.dumps({"value": value}), flush=True)


def phase_parent_ab(parent: str):
    """The forward against the parent commit's, from the two trees in
    turns on this card: one worker process a tree (:func:`ab_worker`),
    asked alternately (:func:`paired`) at each of ``PARENT_CASES``, after
    a check that both give the same y bit for bit."""
    here = os.path.dirname(os.path.abspath(__file__))
    check(os.path.isdir(os.path.join(parent, "dptpu_torch")),
          f"--parent {parent}: no dptpu_torch package there")
    workers = {}

    def answer(side, timeout_s):
        w = workers[side]
        ready, _, _ = select.select([w.stdout], [], [], timeout_s)
        check(bool(ready), f"parent A/B: the {side} worker gave no answer "
                           f"in {timeout_s} s")
        line = w.stdout.readline()
        if not line:
            fail(f"parent A/B: the {side} worker exited ({w.wait()})")
        return json.loads(line)

    def ask(side, req):
        workers[side].stdin.write(json.dumps(req) + "\n")
        workers[side].stdin.flush()
        return answer(side, AB_ANSWER_S)["value"]

    try:
        for side, tree in (("change", here), ("parent", parent)):
            workers[side] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ab-worker",
                 os.path.abspath(tree)],
                cwd=tree, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
        for side in workers:  # each tree builds its own kernels first
            answer(side, TOOL_TIMEOUT_S)
        for label, shape, dtype, what in PARENT_CASES:
            req = {"shape": list(shape), "dtype": dtype}
            digests = {side: ask(side, dict(req, what="digest"))
                       for side in workers}
            check(digests["change"] == digests["parent"],
                  f"parent A/B {label} {dtype}: the two trees' y differ")
            p = paired(lambda: ask("change", dict(req, what=what)),
                       lambda: ask("parent", dict(req, what=what)))
            scale = 1e3 if what == "device" else 1.0  # to us
            print(f"A/B fused_stem_fwd against {parent}: {label} {dtype} "
                  f"{list(shape)}, {what} time a call (y bitwise equal in "
                  f"both trees): this tree {p['a_ms'] * scale:.1f} us, that "
                  f"one {p['b_ms'] * scale:.1f} us; this - that over {PAIRS}"
                  f" paired samples: median {p['delta_ms'] * scale:.2f} us, "
                  f"IQR {p['q1'] * scale:.2f}..{p['q3'] * scale:.2f} us, "
                  f"min..max {p['min'] * scale:.2f}..{p['max'] * scale:.2f} "
                  f"us: {paired_verdict(p, 'that tree')}", flush=True)
    finally:
        for w in workers.values():
            w.stdin.close()
            try:
                w.wait(timeout=60)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()


# shapes that reach the backward kernel's other code paths, gated and not
# timed: channel counts that leave a vector tail or take the scalar
# instantiation, pooled planes that are no multiple of the 8 x 8 tile, and
# two layouts ("offset": z one element past a 16-byte boundary, so the
# scalar instantiation runs; "strided g": a g that is not NHWC-contiguous,
# which the wrapper copies)
BWD_PATH_CASES = (
    ((2, 18, 18, 24), None), ((2, 18, 18, 72), None), ((2, 10, 30, 3), None),
    ((3, 114, 114, 64), None), ((2, 30, 226, 64), None),
    ((2, 18, 18, 64), "offset"), ((2, 18, 18, 64), "strided g"),
)


def _bwd_layout(z, g, layout):
    """``z`` and ``g`` in the layout a gate case asks for: ``z`` copied one
    element past its allocation's start, or ``g`` as an NHWC view of an
    NCHW-contiguous tensor."""
    import torch

    if layout == "offset":
        flat = torch.empty(z.numel() + 1, dtype=z.dtype, device=z.device)
        shifted = flat[1:].view(z.shape)
        shifted.copy_(z)
        return shifted, g
    if layout == "strided g":
        return z, g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return z, g


def phase_backward_kernel():
    """Fused stem backward kernel vs its plain version at the train stem,
    at small and odd shapes and at the cases of ``BWD_PATH_CASES``, f32 and
    bf16, randn and tie-heavy inputs, negative gammas: dz bitwise,
    dgamma_t/dbeta_t within the JAX test's tolerance, two launches bitwise
    equal. Times each of the first shapes beside its bound, prints the
    kernel's registers, shared memory, occupancy and achieved rate at the
    train stem, and times the stem modules' forward + backward there.
    Returns the train-stem bf16 row of the kernel table."""
    import torch

    from dptpu_torch.ops.fused_stem import (
        affine_relu_pool_backward,
        affine_relu_pool_backward_plain,
        backward_kernel_attrs,
        vectorized,
    )

    rng = np.random.RandomState(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    row = None
    max_err = 0.0
    slice_shapes = [TRAIN_STEM, (2, 112, 112, 64)]
    timed = slice_shapes + [(2, 8, 8, 64), (2, 32, 32, 64), (1, 7, 9, 64),
                            (2, 15, 15, 64)]
    for dtype, itemsize, bits in ((torch.float32, 4, torch.int32),
                                  (torch.bfloat16, 2, torch.int16)):
        for shape, layout in [(s, None) for s in timed] + list(BWD_PATH_CASES):
            gamma, beta = _stem_case(rng, shape, dtype)
            b, h, w, c = shape
            g = torch.randn((b, (h + 1) // 2, (w + 1) // 2, c),
                            device="cuda", generator=gen).to(dtype)
            zs = torch.randn(shape, device="cuda", generator=gen)
            launches0 = affine_relu_pool_backward.launches
            copies0 = affine_relu_pool_backward.g_copies
            for kind, zn in (("randn", zs), ("ties", torch.round(zs * 2) / 2)):
                z, g_in = _bwd_layout(zn.to(dtype), g, layout)
                got = affine_relu_pool_backward(z, gamma, beta, g_in)
                again = affine_relu_pool_backward(z, gamma, beta, g_in)
                ref = affine_relu_pool_backward_plain(z, gamma, beta, g_in)
                torch.cuda.synchronize()
                what = (f"fused stem backward {dtype} {shape}"
                        f"{f' ({layout})' if layout else ''} {kind}")
                check(all(a.shape == r.shape and a.dtype == r.dtype
                          for a, r in zip(got, ref)),
                      f"{what}: kernel gives "
                      f"{[(tuple(a.shape), a.dtype) for a in got]}, plain "
                      f"{[(tuple(r.shape), r.dtype) for r in ref]}")
                errs = [(a.float() - r.float()).abs().max().item()
                        for a, r in zip(got, ref)]
                max_err = max(max_err, *errs)
                check(torch.equal(got[0].view(bits), ref[0].view(bits)),
                      f"{what}: dz differs from the plain version "
                      f"(max|Δ| {errs[0]})")
                for name, a, r in (("dgamma_t", got[1], ref[1]),
                                   ("dbeta_t", got[2], ref[2])):
                    check(torch.allclose(a.float(), r.float(), rtol=BWD_RTOL,
                                         atol=BWD_ATOL),
                          f"{what}: {name} differs from the plain version "
                          f"by {(a.float() - r.float()).abs().max().item()}")
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"{what}: two launches differ (not deterministic)")
            path = ("vectorized" if vectorized(z, g_in.contiguous())
                    else "scalar-channel")
            verdict = (f"dz bitwise equal to plain, dgamma/dbeta within rtol "
                       f"{BWD_RTOL:g} atol {BWD_ATOL:g}, deterministic (randn "
                       f"+ ties, negative gamma; {path} instantiation")
            name = (f"kernel fused_stem_bwd {str(dtype)[6:]} {list(shape)}"
                    f"{f' ({layout})' if layout else ''}")
            if layout == "strided g":
                copies = affine_relu_pool_backward.g_copies - copies0
                check(copies == 4, f"{name}: {copies} incoming-gradient "
                                   f"copies, want one per launch (4)")
                verdict += f", g copied to NHWC {copies} times"
            if shape not in timed:
                print(f"{name}: {verdict}; not timed)", flush=True)
                continue
            ms = time_ms(lambda: affine_relu_pool_backward(z, gamma, beta, g))
            plain_ms = time_ms(
                lambda: affine_relu_pool_backward_plain(z, gamma, beta, g),
                reps=7, per_window=3)
            bound = stem_bwd_bound_ms(shape, itemsize)
            print(f"{name}: {verdict}); kernel {ms * 1e3:.1f} us, plain "
                  f"{plain_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
                  f"({bound / ms:.1%} of bound), launches in this check and "
                  f"its timing {affine_relu_pool_backward.launches - launches0}"
                  f"{'' if shape in slice_shapes else ' (not a slice shape)'}",
                  flush=True)
            if shape == TRAIN_STEM:
                attrs = backward_kernel_attrs(dtype, True, c)
                gb_per_s = bound * HBM_BYTES_PER_S / ms / 1e9
                print(f"kernel fused_stem_bwd {str(dtype)[6:]} {list(shape)} "
                      f"vectorized instantiation: {attrs['registers']} "
                      f"registers a thread, {attrs['local_bytes']} local "
                      f"(spill) bytes a thread, {attrs['shared_bytes']} "
                      f"shared bytes and {attrs['threads']} threads a block, "
                      f"{attrs['blocks_per_sm']} resident blocks an SM; "
                      f"achieved {gb_per_s:.1f} GB/s of the "
                      f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s bound", flush=True)
                fused_ms, unfused_ms = stem_modules_ms(z, g)
                print(f"information: train-mode stem module forward + "
                      f"backward {str(dtype)[6:]} {list(shape)}"
                      f"{' under bf16 autocast' if itemsize == 2 else ''}: "
                      f"fused FusedBNReLUPool {fused_ms * 1e3:.1f} us, "
                      f"unfused BatchNorm2d -> ReLU -> MaxPool2d "
                      f"{unfused_ms * 1e3:.1f} us", flush=True)
                if dtype is torch.bfloat16:
                    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
    row["max_abs_err"] = max_err
    return row


def stem_modules_ms(z, g):
    """Forward + backward of the train-mode stem modules on the input the
    train step gives them (z as a channels_last NCHW view, with a
    gradient; f32 weights) and the output gradient g: the fused
    ``FusedBNReLUPool`` (batch mean and mean² in f32, the EMA, the fold,
    both kernels, and autograd through the statistics) and the unfused
    ``BatchNorm2d`` -> ``ReLU`` -> ``MaxPool2d`` the model runs without
    ``DPTPU_FUSED_STEM``, under bf16 autocast for a bf16 z as the train
    step runs them. Returns ``(fused_ms, unfused_ms)``."""
    import torch
    from torch import nn

    from dptpu_torch.models.layers import BatchNorm2d, FusedBNReLUPool

    x = z.permute(0, 3, 1, 2).detach().requires_grad_(True)
    gy = g.permute(0, 3, 1, 2)
    c = z.shape[-1]
    autocast = (torch.autocast("cuda", dtype=torch.bfloat16)
                if z.dtype == torch.bfloat16 else contextlib.nullcontext())
    times = []
    for stem in (FusedBNReLUPool(c),
                 nn.Sequential(BatchNorm2d(c), nn.ReLU(inplace=True),
                               nn.MaxPool2d(3, stride=2, padding=1))):
        stem = stem.to(z.device).train()

        def run():
            with autocast:
                y = stem(x)
            y.backward(gy)

        times.append(time_ms(run, reps=10, per_window=5))
    return times[0], times[1]


def _probe_library(kernel: str):
    """The one PyTorch call that computes the probe's function (the
    yardstick beside the kernel; the port never calls it), or None."""
    import torch
    import torch.nn.functional as F

    def halves(x, axis):
        n = x.shape[axis] // 2
        return x.narrow(axis, 0, n), x.narrow(axis, n, n)

    def split(axis):
        def cat_parities(x):
            lead = (slice(None),) * axis
            return torch.cat([x[lead + (slice(0, None, 2),)],
                              x[lead + (slice(1, None, 2),)]], dim=axis)
        return cat_parities

    def interleave(axis):
        return lambda x: torch.stack(halves(x, axis), dim=axis + 1).reshape(
            x.shape)

    return {
        "k_squeeze": lambda x: torch.mul(x, 2.0),
        "k_parity": split(0), "k_parity_col": split(1),
        "k_interleave": interleave(0),
        "k_lead": split(1), "k_sub": split(2),
        "k_il0": interleave(1), "k_il1": interleave(2),
        "k_tap": lambda x: F.pad(x[:, 1:, 1:], (0, 0, 0, 1, 0, 1)),
    }.get(kernel)


def probe_bound_ms(kernel: str, shape) -> float:
    """Least time for a layout probe: read the input once (``k_tap`` only
    the [H-1, W-1] corner it shifts in), write the output once (and
    ``k_accum``'s [L] f32 sum), at the card's memory rate — no probe does
    more than one operation per element, so bytes bind. At [112,112,2,
    4096] or [128,112,112,64] f32: 822.1 MB, 245.4 us (k_tap 243.2 us)."""
    n = int(np.prod(shape))
    read = n
    if kernel == "k_tap":
        b, h, w, c = shape
        read = b * (h - 1) * (w - 1) * c
    extra = shape[3] if kernel == "k_accum" else 0
    return (read + n + extra) * 4 / HBM_BYTES_PER_S * 1e3


def phase_layout_probes():
    """The ten layout probe kernels against their plain versions, bitwise,
    at each script's shape, a ragged one and the train stem's size; the
    accumulator against an f64 sum and itself; the library call against
    the kernel, bitwise. Each timed at the script's shape and the train
    stem's size, against its library call in a paired A/B
    (:func:`paired_ms`). Returns ``{kernel:
    row}`` with the train-stem-size times of the kernel table."""
    import torch

    from dptpu_torch.ops import layout_probes

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for probe in layout_probes.PROBES:
        lib = _probe_library(probe.kernel)
        max_err = 0.0
        for shape in PROBE_SHAPES[probe.script]:
            x = torch.randn(shape, device="cuda", generator=gen)
            got, again, ref = probe(x), probe(x), probe.plain(x)
            torch.cuda.synchronize()
            what = f"{probe.kernel} {list(shape)}"
            if probe is layout_probes.accum:
                (got, acc), (again, acc2), (ref, _) = got, again, ref
                exact = x.double().sum(dim=(0, 1, 2))
                rel = ((acc.double() - exact).abs().max()
                       / exact.abs().max()).item()
                check(torch.allclose(acc.double(), exact, rtol=ACCUM_RTOL,
                                     atol=0.0),
                      f"{what}: the accumulator differs from the f64 sum by "
                      f"{rel:.3e} of its largest lane (rtol {ACCUM_RTOL:g})")
                check(torch.equal(acc.view(torch.int32),
                                  acc2.view(torch.int32)),
                      f"{what}: two launches' accumulators differ (not "
                      f"deterministic)")
            err = (got - ref).abs().max().item()
            max_err = max(max_err, err)
            check(got.shape == ref.shape and torch.equal(
                got.view(torch.int32), ref.view(torch.int32)) and torch.equal(
                got.view(torch.int32), again.view(torch.int32)),
                f"{what}: the kernel differs from its plain version (max|Δ| "
                f"{err}) or from its own second launch")
            if lib is not None:
                check(torch.equal(lib(x).view(torch.int32),
                                  got.view(torch.int32)),
                      f"{what}: the library call computes another function")
            big = shape == PROBE_SHAPES[probe.script][2]
            if shape == PROBE_SHAPES[probe.script][1]:
                print(f"kernel {what}: bitwise equal to plain (ragged "
                      f"shape, not timed)", flush=True)
                continue
            lib_ms = None
            if lib is None:
                ms = time_ms(lambda: probe(x))
            else:
                paired = paired_ms(lambda: probe(x), lambda: lib(x))
                ms, lib_ms = paired["a_ms"], paired["b_ms"]
            plain_ms = time_ms(lambda: probe.plain(x), reps=7, per_window=3)
            bound = probe_bound_ms(probe.kernel, shape)
            if probe is layout_probes.accum:
                copy_ms = time_ms(lambda: x.clone())
                sum_ms = time_ms(lambda: x.sum(dim=(0, 1, 2)))
                verdict = "bitwise equal to plain and deterministic"
                extra = (f"; library: none in one call — copy x.clone() "
                         f"{copy_ms * 1e3:.1f} us, sum x.sum((0,1,2)) "
                         f"{sum_ms * 1e3:.1f} us; accumulator rel err vs f64 "
                         f"{rel:.2e}")
            else:
                verdict = "bitwise equal to plain"
                extra = (f", library {lib_ms * 1e3:.1f} us; kernel - library "
                         f"over {PAIRS} paired windows: median "
                         f"{paired['delta_ms'] * 1e3:.2f} us, IQR "
                         f"{paired['q1'] * 1e3:.2f}..{paired['q3'] * 1e3:.2f} "
                         f"us, min..max {paired['min'] * 1e3:.2f}.."
                         f"{paired['max'] * 1e3:.2f} us: "
                         f"{paired_verdict(paired)}")
            print(f"kernel {what}: {verdict}; kernel {ms * 1e3:.1f} us, "
                  f"plain {plain_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
                  f"({bound / ms:.1%} of bound){extra}"
                  f"{'' if big else ' (launch-bound size)'}", flush=True)
            if big:
                rows[probe.kernel] = {"ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound, "library_ms": lib_ms}
            del got, again, ref
        rows[probe.kernel]["max_abs_err"] = max_err
    return rows


def _run_tool(module: str):
    """``python -m <module>`` on the card from the repository root; its
    output is printed, and a nonzero exit fails the phase. Returns the
    output's JSON lines, parsed."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module], cwd=here,
                         capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in out.stdout.splitlines():
        print(f"  {module}: {line}", flush=True)
    check(out.returncode == 0,
          f"python -m {module} exited {out.returncode}:\n{out.stderr}")
    print(f"tool python -m {module}: exit 0 in {wall:.1f}s", flush=True)
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def phase_tools():
    """The tooling path: the two probe tools and the stem bench as the
    user runs them. Returns ``({kernel: launches}, stem_bench times)``."""
    launches = {}
    for module in ("dptpu_torch.tools.probe_mosaic",
                   "dptpu_torch.tools.probe_mosaic2"):
        counts = next(j["launches"] for j in _run_tool(module)
                      if "launches" in j)
        check(counts and all(n == 1 for n in counts.values()),
              f"{module}: launch counters {counts}, want 1 per probe")
        launches.update(counts)
    bench = next(j["stem_bench"] for j in _run_tool(
        "dptpu_torch.tools.stem_bench") if "stem_bench" in j)
    check(bench["parity_ok"] and all(bench["launches"].values()),
          f"stem_bench: parity {bench['parity_ok']}, launches "
          f"{bench['launches']}")
    print(f"information: stem function, bf16 {bench['shape']}: forward "
          f"stock {bench['fwd_stock_ms'] * 1e3:.1f} us, fused "
          f"{bench['fwd_fused_ms'] * 1e3:.1f} us; forward + backward stock "
          f"{bench['fwd_bwd_stock_ms'] * 1e3:.1f} us, fused "
          f"{bench['fwd_bwd_fused_ms'] * 1e3:.1f} us", flush=True)
    return launches, bench


def _zero_counters():
    from dptpu_torch.ops import fused_stem

    fused_stem.affine_relu_pool_forward.launches = 0
    fused_stem.affine_relu_pool_backward.launches = 0
    fused_stem.affine_relu_pool_backward.g_copies = 0


def _counters():
    from dptpu_torch.ops import fused_stem

    return (fused_stem.affine_relu_pool_forward.launches,
            fused_stem.affine_relu_pool_backward.launches,
            fused_stem.affine_relu_pool_backward.g_copies)


@contextlib.contextmanager
def _fused_stem_env():
    os.environ["DPTPU_FUSED_STEM"] = "1"
    try:
        yield
    finally:
        del os.environ["DPTPU_FUSED_STEM"]


def phase_serve():
    """The serving path through the CLI, with every kernel counter zeroed
    just before it and read just after."""
    from dptpu_torch import cli

    with _fused_stem_env():
        _zero_counters()
        t0 = time.perf_counter()
        stats = cli.main(["serve", "-a", "resnet50", "--buckets",
                          "1,4,16,64", "--selftest", "64"])
        wall = time.perf_counter() - t0
        fwd, bwd, _ = _counters()
    check(stats["completed"] == 64 and stats["failed"] == 0,
          f"selftest: {stats['completed']} ok, {stats['failed']} failed "
          f"(want 64 ok, 0 failed)")
    # one warm-up forward per exec size (2, 4, 16, 64) on the constructing
    # thread, and again on the batcher's dispatch thread
    warmups = 2 * 4
    check(fwd == warmups + stats["batches"] and bwd == 0,
          f"serving launched the fused stem forward {fwd} times and the "
          f"backward {bwd} times, want {warmups} warm-ups + "
          f"{stats['batches']} batches and no backward")
    lat = stats["latency_ms"]
    print(f"serve slice: resnet50 fused stem, 64 requests in {wall:.2f}s "
          f"(engine build included): p50 {lat['p50']:.2f} ms, p99 "
          f"{lat['p99']:.2f} ms, buckets {stats['bucket_counts']}, "
          f"{stats['batches']} batches, fused stem forward launches {fwd}",
          flush=True)
    return fwd


def phase_serve_outputs():
    """Right serving answers: fused vs unfused stem (gated), card vs plain
    CPU path (gated), bucket 1 vs bucket 16 (printed)."""
    import torch

    from dptpu_torch.models import create_model
    from dptpu_torch.serve.engine import ServeEngine

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = create_model("resnet50").state_dict()
    rng = np.random.RandomState(1)
    # non-trivial BN: the fold is what differs between the two stems
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.randn(v.numel()) * 0.1))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.rand(v.numel()) * 0.5 + 0.75))
    images = rng.randint(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    logits = {}
    for fused in (True, False):
        eng = ServeEngine("resnet50", buckets=(1, 16), variables=sd,
                          fused_stem=fused, device="cuda")
        logits[fused] = eng.infer(images)
        if fused:
            solo = np.concatenate([eng.infer(images[i:i + 1])
                                   for i in range(16)])
        del eng
    scale = float(np.abs(logits[False]).max())
    for name, arr in logits.items():
        check(arr.shape == (16, 1000) and bool(np.isfinite(arr).all()),
              f"{'fused' if name else 'unfused'} logits: shape "
              f"{arr.shape}, finite {bool(np.isfinite(arr).all())}")
    d_fused = float(np.abs(logits[True] - logits[False]).max())
    print(f"outputs: fused vs unfused stem max|Δlogit| {d_fused:.3e} "
          f"(max|logit| {scale:.3e}, ratio {d_fused / scale:.3e}, gate "
          f"{FUSED_VS_UNFUSED_REL:.0e})", flush=True)
    check(d_fused <= FUSED_VS_UNFUSED_REL * scale,
          f"fused vs unfused stem max|Δlogit| {d_fused} > "
          f"{FUSED_VS_UNFUSED_REL} x {scale}")
    d_bucket = float(np.abs(solo - logits[True]).max())
    print(f"outputs: bucket 1 vs bucket 16, same rows, max|Δlogit| "
          f"{d_bucket:.3e} (information: cuDNN may pick its algorithm by "
          f"batch size)", flush=True)
    cpu = ServeEngine("resnet50", buckets=(2,), variables=sd,
                      fused_stem=True, device="cpu")
    ref = cpu.infer(images[:2])
    d_cpu = float(np.abs(ref - logits[True][:2]).max())
    print(f"outputs: card vs plain CPU path (fused stem, 2 rows) "
          f"max|Δlogit| {d_cpu:.3e} (gate {GPU_VS_CPU_REL:.0e} x "
          f"{scale:.3e})", flush=True)
    check(d_cpu <= GPU_VS_CPU_REL * scale,
          f"card vs CPU logits max|Δ| {d_cpu} > {GPU_VS_CPU_REL} x {scale}")


def phase_train():
    """The training path through the CLI: ResNet-50, bf16, batch 128, one
    epoch of 10 steps and one val batch, with every kernel counter zeroed
    just before it and read just after. Returns the counters."""
    from dptpu_torch import cli

    with _fused_stem_env():
        _zero_counters()
        out = cli.main(["train", "synthetic:1280", "-a", "resnet50", "-b",
                        "128", "--epochs", "1", "--opt-level", "O2",
                        "--seed", "0"])
        fwd, bwd, copies = _counters()
    steps, val = out["train_steps"], out["val_batches"]
    losses = out["step_losses"]
    check(steps == 10 and val == 1 and len(losses) == steps,
          f"train: {steps} steps, {val} val batches, {len(losses)} losses "
          f"(want 10, 1, 10)")
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    check(np.isfinite(out["history"][0]["val"]["loss"]),
          f"train: the val loss is not finite: {out['history'][0]['val']}")
    # no warm-up forwards: one forward per train step and per val batch
    warmups = 0
    check(bwd == steps,
          f"train: fused stem backward launched {bwd} times, want one per "
          f"train step ({steps})")
    check(fwd == steps + val + warmups,
          f"train: fused stem forward launched {fwd} times, want {steps} "
          f"train steps + {val} val batches + {warmups} warm-ups")
    print(f"train slice: resnet50 bf16 batch 128, losses "
          f"{[round(x, 4) for x in losses]}; {out['img_per_s']:.1f} img/s "
          f"steady state over {out['steady_steps']} event-fenced steps; "
          f"{steps} steps + {val} val batch in {out['wall_s']:.2f}s (build "
          f"and cuDNN plans included); fused stem launches forward {fwd}, "
          f"backward {bwd}, incoming-gradient copies {copies}", flush=True)
    return fwd, bwd


def _one_step(sd, batch, fused: bool, device: str):
    """Loss and gradients of one fp32 SGD step of ResNet-50 from the state
    dict ``sd`` on ``batch`` (TF32 off: the train step runs fp32 exact)."""
    import torch

    from dptpu_torch.models import create_model
    from dptpu_torch.models.convert import load_weights
    from dptpu_torch.train.state import create_train_state
    from dptpu_torch.train.step import make_train_step

    model = create_model("resnet50", fused_stem=fused)
    load_weights(model, sd)
    model = model.to(device, memory_format=torch.channels_last)
    state = create_train_state(model)
    step = make_train_step(None, torch.float32, lambda count: 0.1)
    on_device = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    _, metrics = step(state, on_device)
    grads = {k: p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads


def _compare_steps(what, a, b, gate=True):
    """Loss and every gradient leaf of two one-step runs; a leaf whose
    gradient is exactly zero in ``b`` (a zero-initialized residual
    branch's interior) must be exactly zero in ``a`` too."""
    (la, ga), (lb, gb) = a, b
    rel = abs(la - lb) / abs(lb)
    elem, l2, zero_mismatch = {}, {}, []
    for k, ref in gb.items():
        peak = float(ref.abs().max())
        if peak == 0.0:
            if float(ga[k].abs().max()) != 0.0:
                zero_mismatch.append(k)
            continue
        d = ga[k] - ref
        elem[k] = float(d.abs().max()) / peak
        l2[k] = float(d.norm()) / float(ref.norm())
    worst = max(elem, key=elem.get)
    worst_l2 = max(l2, key=l2.get)
    print(f"training outputs: {what}: loss {la:.6f} vs {lb:.6f} (relative "
          f"{rel:.3e}{f', gate {STEP_LOSS_REL:.0e}' if gate else ''}); "
          f"worst leaf max|Δg|/max|g| {elem[worst]:.3e} ({worst}"
          f"{f', gate {STEP_GRAD_REL:.0e}' if gate else ''}); worst leaf "
          f"||Δg||/||g|| {l2[worst_l2]:.3e} ({worst_l2}); {len(elem)} leaves "
          f"compared, {len(gb) - len(elem)} exactly zero", flush=True)
    if not gate:
        return
    check(rel <= STEP_LOSS_REL, f"{what}: loss differs by {rel:.3e} relative")
    check(elem[worst] <= STEP_GRAD_REL,
          f"{what}: gradient {worst} differs by {elem[worst]:.3e} of its "
          f"max|grad|")
    check(not zero_mismatch,
          f"{what}: gradients {zero_mismatch[:4]} are zero in one run only")


def phase_train_outputs():
    """Right training answers: one fp32 step of ResNet-50 at 224, batch 8,
    from the same weights and batch — fused vs unfused stem on the card,
    and the card vs the plain CPU path (both gated); the same step with
    conv1's weights moved by 1 ulp, as the floor, from the gate's
    zero_init_residual weights and from the plain seeded init (printed)."""
    import torch

    from dptpu_torch.models import create_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        seeded = create_model("resnet50").state_dict()
    rng = np.random.RandomState(2)
    batch = {"images": rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8),
             "labels": rng.randint(0, 1000, 8).astype(np.int64)}

    def conv1_moved(state_dict):
        return dict(state_dict, **{
            "conv1.weight": state_dict["conv1.weight"] * (1 + 2.0 ** -22)})

    _compare_steps("floor of the plain seeded init: unfused, conv1 moved by "
                   "1 ulp (information)",
                   _one_step(conv1_moved(seeded), batch, False, "cuda"),
                   _one_step(seeded, batch, False, "cuda"), gate=False)
    # zero_init_residual: every bottleneck's last BN scale 0
    sd = {k: torch.zeros_like(v) if k.endswith("bn3.weight") else v
          for k, v in seeded.items()}
    fused = _one_step(sd, batch, True, "cuda")
    unfused = _one_step(sd, batch, False, "cuda")
    for name, (loss, grads) in (("fused", fused), ("unfused", unfused)):
        check(np.isfinite(loss) and all(bool(torch.isfinite(g).all())
                                        for g in grads.values()),
              f"{name} fp32 step: a loss or gradient is not finite")
    _compare_steps("floor: unfused, conv1 moved by 1 ulp (information)",
                   _one_step(conv1_moved(sd), batch, False, "cuda"), unfused,
                   gate=False)
    _compare_steps("fused vs unfused stem (card)", fused, unfused)
    cpu = _one_step(sd, batch, True, "cpu")
    _compare_steps("card vs plain CPU path (fused stem)", fused, cpu)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="the port's proof that it starts on the GPU")
    parser.add_argument(
        "--parent", metavar="DIR",
        help="instead of the smoke, time the forward kernel against DIR's "
             "(a tree of the parent commit, e.g. from git archive) in "
             "turns on this card")
    parser.add_argument("--ab-worker", metavar="TREE",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    if args.ab_worker:
        ab_worker(args.ab_worker)
        return
    try:
        import dptpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the dptpu_torch package is not beside chip_smoke.py: {e}")
    phase_device()
    phase_build()
    if args.parent:
        phase_parent_ab(args.parent)
        return
    fwd_row = phase_forward_kernel()
    bwd_row = phase_backward_kernel()
    t0 = time.perf_counter()
    probe_rows = phase_layout_probes()
    tool_launches, _ = phase_tools()
    print(f"layout probes and tools: {time.perf_counter() - t0:.1f}s",
          flush=True)
    from dptpu_torch.ops.layout_probes import PROBES

    for probe in PROBES:
        probe.launches = 0
    serve_fwd = phase_serve()
    phase_serve_outputs()
    train_fwd, train_bwd = phase_train()
    phase_train_outputs()
    on_paths = {p.kernel: p.launches for p in PROBES if p.launches}
    check(not on_paths, f"layout probes launched on the serve and train "
                        f"paths: {on_paths}")
    print(f"launches on the main paths: serve forward {serve_fwd}; train "
          f"forward {train_fwd}, backward {train_bwd} (the kernel table "
          f"reports the train path's); layout probes 0 on the serve and "
          f"train paths, {tool_launches} in the tool runs", flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "fused_stem_fwd",
            "route": "cuda",
            "source": "dptpu_torch/csrc/fused_stem_fwd.cu",
            "replaces": "dptpu/ops/fused_stem.py:169",
            "launches": train_fwd,
            "max_abs_err": fwd_row["max_abs_err"],
            "ms": fwd_row["ms"],
            "plain_ms": fwd_row["plain_ms"],
            "bound_ms": fwd_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "serve_exec64_f32_ms": fwd_row["serve_exec64_f32_ms"],
            "serve_exec64_f32_bound_ms": fwd_row["serve_exec64_f32_bound_ms"],
        },
        {
            "name": "fused_stem_bwd",
            "route": "cuda",
            "source": "dptpu_torch/csrc/fused_stem_bwd.cu",
            "replaces": "dptpu/ops/fused_stem.py:192",
            "launches": train_bwd,
            "max_abs_err": bwd_row["max_abs_err"],
            "ms": bwd_row["ms"],
            "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
    ] + [
        {
            "name": probe.kernel,
            "route": "cuda",
            "source": ("dptpu_torch/csrc/probe_mosaic.cu"
                       if probe.script == "probe_mosaic"
                       else "dptpu_torch/csrc/probe_mosaic2.cu"),
            "replaces": probe.replaces,
            "launches": tool_launches[probe.kernel],
            "max_abs_err": probe_rows[probe.kernel]["max_abs_err"],
            "ms": probe_rows[probe.kernel]["ms"],
            "plain_ms": probe_rows[probe.kernel]["plain_ms"],
            "bound_ms": probe_rows[probe.kernel]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": probe_rows[probe.kernel]["library_ms"],
        }
        for probe in PROBES
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
