"""Fused stem: BN-affine + ReLU + 3x3/2 max-pool in one pass, and its
fused backward.

    y = maxpool_3x3s2p1(relu(gamma_t * z + beta_t))        (z, y NHWC)

``gamma_t = weight * rsqrt(var + eps)`` and ``beta_t = bias - mean *
gamma_t`` are the BN affine with the statistics folded in. ReLU and the
affine are monotone per channel, so the pool commutes with them and the
112x112 ReLU plane never has to be written. The port of
``dptpu/ops/fused_stem.py``:

* :func:`affine_relu_pool_plain` — plain PyTorch, the port of
  ``_fwd_xla``: affine in f32, -inf-padded 3x3/2 max, ReLU, cast back to
  ``z.dtype``. The CPU path, and the oracle the forward kernel is held
  against.
* :func:`affine_relu_pool_backward_plain` — plain PyTorch, the port of
  ``_bwd_xla``: recompute the window max and its first-strict-max winner
  from ``z``, route ``g`` through <= 4 parity taps (a gather, no
  scatter), and sum ``dgamma_t``/``dbeta_t`` on the pooled grid.
* :func:`affine_relu_pool_forward` / :func:`affine_relu_pool_backward` —
  the two kernels' wrappers. A CPU tensor takes the plain version; a
  CUDA tensor launches the hand-written Hopper kernel
  (``dptpu_torch/csrc/fused_stem_fwd.cu``, the port of ``_fwd_kernel``;
  ``dptpu_torch/csrc/fused_stem_bwd.cu``, the port of ``_bwd_kernel``)
  or raises — no fallback. Each wrapper's ``launches`` counts its
  kernel's launches.
* :func:`affine_relu_pool` — the public op, differentiable: a
  ``torch.autograd.Function`` whose backward is the fused backward (the
  custom VJP of ``_affine_relu_pool_even``); it saves ``(z, gamma_t,
  beta_t)``, not ``y``. Unlike the JAX op, odd spatial dims take the
  fused backward too (the JAX op differentiates the plain composition
  there, because its parity interleave only rebuilds ``2*oh x 2*ow``
  planes): the gather drops the row and column past an odd edge, and
  the gradient is the same, so a CUDA tensor of any size runs both
  kernels.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def affine_relu_pool_plain(z: torch.Tensor, gamma_t: torch.Tensor,
                           beta_t: torch.Tensor) -> torch.Tensor:
    """maxpool_3x3s2p1(relu(gamma_t * z + beta_t)) in plain PyTorch; NHWC
    in, NHWC contiguous out, in ``z.dtype``. The affine is two separately
    rounded f32 operations, the pool pads with -inf, and the ReLU maps
    every non-positive value to +0 — the exact arithmetic the kernel
    reproduces bit for bit."""
    a = gamma_t.float() * z.float() + beta_t.float()
    pooled = F.max_pool2d(a.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    y = torch.where(pooled > 0, pooled, torch.zeros_like(pooled))
    return y.to(z.dtype).contiguous()


def affine_relu_pool_backward_plain(z: torch.Tensor, gamma_t: torch.Tensor,
                                    beta_t: torch.Tensor, g: torch.Tensor):
    """The fused backward in plain PyTorch (the port of ``_bwd_xla``).
    ``z``: NHWC ``[B, H, W, C]``, any H, W >= 1; ``g``: the gradient of
    ``y``, ``[B, ceil(H/2), ceil(W/2), C]``. Returns ``(dz, dgamma_t, dbeta_t)``:
    ``dz`` in ``z.dtype``; the affine grads in f32 (the f32 products are
    summed in f64 and rounded once, so the result does not depend on the
    summation order), cast to ``gamma_t``'s and ``beta_t``'s dtypes.

    The winner of each window is the first strict maximum of the affine
    in the offset order ``k = 3r + s`` (select_and_scatter's tie-break);
    the ReLU mask is ``best > 0``; ``dz`` gathers <= 4 parity taps summed
    in a fixed order and is multiplied once by ``gamma_t`` — the exact
    arithmetic the kernel reproduces bit for bit. On an odd plane the
    last window covers one -inf padding row or column, and the rebuilt
    ``2*oh x 2*ow`` plane loses the row or column past the edge."""
    _check_grad_shape(z, g)
    b, h, w, c = z.shape
    oh, ow = g.shape[1], g.shape[2]
    gam = gamma_t.float()
    a = gam * z.float() + beta_t.float()
    # NHWC: F.pad's pairs run (C, W, H) from the last dim
    ap = F.pad(a, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    zp = F.pad(z.float(), (0, 0, 1, 1, 1, 1), value=0.0)
    best = widx = zwin = None
    for r in range(3):
        for s in range(3):
            k = 3 * r + s
            ars = ap[:, r:r + 2 * oh - 1:2, s:s + 2 * ow - 1:2, :]
            zrs = zp[:, r:r + 2 * oh - 1:2, s:s + 2 * ow - 1:2, :]
            if best is None:
                best = ars
                widx = torch.zeros(ars.shape, dtype=torch.uint8,
                                   device=z.device)
                zwin = zrs
            else:
                gt = ars > best  # strict: the earlier offset keeps ties
                best = torch.maximum(ars, best)
                widx = torch.where(gt, torch.full_like(widx, k), widx)
                zwin = torch.where(gt, zrs, zwin)

    # the ReLU mask from the recomputed pre-ReLU max (== y > 0), in f32
    gm = torch.where(best > 0, g.float(), torch.zeros((), device=z.device))
    # the f32 products summed in f64 and rounded once, as the kernel does:
    # two f32 sums of ~200k terms in different orders would not agree
    dgamma_t = (gm * zwin).sum(dim=(0, 1, 2), dtype=torch.float64).float()
    dbeta_t = gm.sum(dim=(0, 1, 2), dtype=torch.float64).float()

    # a zero / 255 apron so the di, dj == 1 taps read nothing past the edge
    gp = F.pad(gm, (0, 0, 0, 1, 0, 1), value=0.0)
    wp = F.pad(widx, (0, 0, 0, 1, 0, 1), value=255)
    zero = torch.zeros((), device=z.device)

    def tap(di, dj, r, s):
        gs = gp[:, di:di + oh, dj:dj + ow, :]
        ws = wp[:, di:di + oh, dj:dj + ow, :]
        return torch.where(ws == 3 * r + s, gs, zero)

    dx00 = tap(0, 0, 1, 1)
    dx01 = tap(0, 0, 1, 2) + tap(0, 1, 1, 0)
    dx10 = tap(0, 0, 2, 1) + tap(1, 0, 0, 1)
    dx11 = tap(0, 0, 2, 2) + tap(0, 1, 2, 0) + tap(1, 0, 0, 2) + tap(1, 1, 0, 0)
    inner0 = torch.stack([dx00, dx01], dim=3)
    inner1 = torch.stack([dx10, dx11], dim=3)
    dy = torch.stack([inner0, inner1], dim=2).reshape(b, 2 * oh, 2 * ow, c)
    dz = (gam * dy[:, :h, :w]).to(z.dtype)
    return dz, dgamma_t.to(gamma_t.dtype), dbeta_t.to(beta_t.dtype)


def _check_grad_shape(z: torch.Tensor, g: torch.Tensor) -> None:
    b, h, w, c = z.shape
    if tuple(g.shape) != (b, (h + 1) // 2, (w + 1) // 2, c):
        raise ValueError(
            f"affine_relu_pool_backward: g must be [B, ceil(H/2), "
            f"ceil(W/2), C] for z {tuple(z.shape)}, got {tuple(g.shape)}")


def _check_cuda_args(op: str, z: torch.Tensor, gamma_t: torch.Tensor,
                     beta_t: torch.Tensor):
    """Raises on what the kernels do not take; returns the dtype codes of
    ``z`` and of ``gamma_t``/``beta_t`` (which the kernels read as they
    are: f32 or bf16, one dtype for both) and ``z``'s device index."""
    if not z.is_cuda:
        raise ValueError(f"{op}: no kernel for device {z.device}")
    if z.dim() != 4:
        raise ValueError(f"{op}: z must be NHWC 4-D, got shape "
                         f"{tuple(z.shape)}")
    if z.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: z dtype {z.dtype} is not float32 or "
                         f"bfloat16")
    if not z.is_contiguous():
        raise ValueError(
            f"{op}: z must be NHWC-contiguous (strides {z.stride()} for "
            f"shape {tuple(z.shape)}); pass a channels_last tensor's "
            f"permute(0, 2, 3, 1) view"
        )
    c, index = z.shape[3], z.get_device()
    for name, t in (("gamma_t", gamma_t), ("beta_t", beta_t)):
        if (t.shape != (c,) or t.get_device() != index
                or not t.is_contiguous()):
            raise ValueError(
                f"{op}: {name} must be a contiguous [{c}] on {z.device}, "
                f"got {tuple(t.shape)} (strides {t.stride()}) on {t.device}"
            )
    vdtype = _DTYPE_CODES.get(gamma_t.dtype)
    if vdtype is None or beta_t.dtype != gamma_t.dtype:
        raise ValueError(f"{op}: gamma_t and beta_t must both be float32 or "
                         f"both bfloat16, got {gamma_t.dtype} and "
                         f"{beta_t.dtype}")
    return _DTYPE_CODES[z.dtype], vdtype, index


def _raise_on_launch_error(op: str, rc: int, z: torch.Tensor) -> None:
    raise RuntimeError(f"{op} kernel launch failed: cudaError {rc} for "
                       f"z {tuple(z.shape)} {z.dtype}")


# the entry points of the built library, looked up once
_entries = None


def _kernels():
    global _entries
    if _entries is None:
        from dptpu_torch.kernels.build import load_library

        lib = load_library()
        _entries = types.SimpleNamespace(
            fwd=lib.dptpu_fused_stem_fwd,
            fwd_attrs=lib.dptpu_fused_stem_fwd_attrs,
            bwd=lib.dptpu_fused_stem_bwd,
            bwd_blocks=lib.dptpu_fused_stem_bwd_blocks,
            bwd_attrs=lib.dptpu_fused_stem_bwd_attrs,
            # a device's current stream handle as an int, the call Triton's
            # launcher makes: torch.cuda.current_stream(i).cuda_stream
            # builds a Stream object first, ~3 us of host time a launch
            stream=torch._C._cuda_getCurrentRawStream)
    return _entries


def _vector_ok(channels: int, itemsize: int, pointer_bits: int) -> int:
    """1 where C is a multiple of the 16-byte vector width and every
    pointer (``pointer_bits``: their bitwise or) is 16-byte aligned."""
    return int(channels % (16 // itemsize) == 0 and pointer_bits % 16 == 0)


def vectorized(*tensors: torch.Tensor) -> bool:
    """Whether a stem kernel takes these tensors (``z`` first) in 16-byte
    channel vectors (8 bf16 or 4 f32 channels a copy): C a multiple of the
    vector width and every tensor 16-byte aligned (a view with a storage
    offset may not be). Otherwise the kernel's scalar-channel
    instantiation runs: same tiling, one channel a thread."""
    bits = 0
    for t in tensors:
        bits |= t.data_ptr()
    z = tensors[0]
    return bool(_vector_ok(z.shape[-1], z.element_size(), bits))


def _kernel_attrs(fn, op: str, dtype: torch.dtype, vectorized: bool,
                  channels: int) -> dict:
    import ctypes

    out = (ctypes.c_int * 5)()
    rc = fn(_DTYPE_CODES[dtype], int(vectorized), channels,
            ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{op} attributes: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm"), out))


def forward_kernel_attrs(dtype: torch.dtype, vectorized: bool,
                         channels: int) -> dict:
    """What the compiler and the occupancy calculator say of the forward
    kernel's instantiation for ``dtype`` (vectorized or scalar) at
    ``channels``: registers and local (spill) bytes a thread, shared
    bytes and threads a block, resident blocks an SM. Needs the card."""
    return _kernel_attrs(_kernels().fwd_attrs, "fused stem forward", dtype,
                         vectorized, channels)


def backward_kernel_attrs(dtype: torch.dtype, vectorized: bool,
                          channels: int) -> dict:
    """:func:`forward_kernel_attrs` of the backward kernel."""
    return _kernel_attrs(_kernels().bwd_attrs, "fused stem backward", dtype,
                         vectorized, channels)


def affine_relu_pool_forward(z: torch.Tensor, gamma_t: torch.Tensor,
                             beta_t: torch.Tensor) -> torch.Tensor:
    """The fused stem forward, no autograd. ``z``: NHWC ``[B, H, W, C]``
    (any H, W >= 1, any C), f32 or bf16; ``gamma_t``/``beta_t``: ``[C]``.
    Returns ``[B, ceil(H/2), ceil(W/2), C]`` in ``z.dtype``.

    On the CPU this is :func:`affine_relu_pool_plain`. On CUDA ``z`` must
    be NHWC-contiguous (a channels_last NCHW tensor's ``permute(0, 2, 3,
    1)`` view is), ``gamma_t``/``beta_t`` contiguous and both f32 or both
    bf16 (the kernel reads them as they are: no cast is launched), and the
    kernel runs on the current stream, vectorized where
    :func:`vectorized` allows; anything it does not take raises."""
    if not z.is_cuda and z.device.type == "cpu":
        return affine_relu_pool_plain(z, gamma_t, beta_t)
    zcode, vcode, index = _check_cuda_args("affine_relu_pool", z, gamma_t,
                                           beta_t)
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return affine_relu_pool_forward(z, gamma_t, beta_t)
    b, h, w, c = z.shape
    y = z.new_empty((b, (h + 1) // 2, (w + 1) // 2, c))
    zp, yp = z.data_ptr(), y.data_ptr()
    fns = _kernels()
    rc = fns.fwd(
        zcode, _vector_ok(c, z.element_size(), zp | yp), vcode, zp,
        gamma_t.data_ptr(), beta_t.data_ptr(), yp, b, h, w, c,
        fns.stream(index),
    )
    if rc:
        _raise_on_launch_error("fused stem forward", rc, z)
    affine_relu_pool_forward.launches += 1
    return y


affine_relu_pool_forward.launches = 0


def affine_relu_pool_backward(z: torch.Tensor, gamma_t: torch.Tensor,
                              beta_t: torch.Tensor, g: torch.Tensor):
    """The fused stem backward, ``(dz, dgamma_t, dbeta_t)``: see
    :func:`affine_relu_pool_backward_plain` for the math and shapes.

    On the CPU this is the plain version. On CUDA it launches the kernel
    on the current stream, vectorized where :func:`vectorized` allows:
    ``z`` must be NHWC-contiguous and ``gamma_t``/``beta_t`` as
    :func:`affine_relu_pool_forward` takes them, and an incoming ``g``
    that is not NHWC-contiguous is copied to NHWC first (counted in
    ``affine_relu_pool_backward.g_copies``). The per-tile partial sums of
    the affine grads go to a buffer allocated here and are summed by a
    second, fixed-order pass, so the result is the same on every run."""
    if not z.is_cuda and z.device.type == "cpu":
        return affine_relu_pool_backward_plain(z, gamma_t, beta_t, g)
    zcode, vcode, index = _check_cuda_args("affine_relu_pool_backward", z,
                                           gamma_t, beta_t)
    _check_grad_shape(z, g)
    b, h, w, c = z.shape
    if g.get_device() != index or g.dtype != z.dtype:
        raise ValueError(
            f"affine_relu_pool_backward: g must be {z.dtype} on {z.device}, "
            f"got {g.dtype} on {g.device}")
    if not g.is_contiguous():
        g = g.contiguous()
        affine_relu_pool_backward.g_copies += 1
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return affine_relu_pool_backward(z, gamma_t, beta_t, g)
    fns = _kernels()
    dz = torch.empty_like(z)
    rows = fns.bwd_blocks(b, h, w, c)
    partials = z.new_empty((2, c, max(rows, 1)), dtype=torch.float64)
    dgb = z.new_empty((2, c), dtype=torch.float32)
    zp, gp, dzp = z.data_ptr(), g.data_ptr(), dz.data_ptr()
    rc = fns.bwd(
        zcode, _vector_ok(c, z.element_size(), zp | gp | dzp), vcode, zp, gp,
        gamma_t.data_ptr(), beta_t.data_ptr(), dzp,
        partials.data_ptr(), dgb.data_ptr(), b, h, w, c,
        fns.stream(index),
    )
    if rc:
        _raise_on_launch_error("fused stem backward", rc, z)
    affine_relu_pool_backward.launches += 1
    return dz, dgb[0].to(gamma_t.dtype), dgb[1].to(beta_t.dtype)


affine_relu_pool_backward.launches = 0
affine_relu_pool_backward.g_copies = 0


class _AffineReluPool(torch.autograd.Function):
    """The custom VJP of ``_affine_relu_pool_even``: the backward
    recomputes the window max from ``z`` (which also yields the ReLU
    mask), so ``y`` is not kept for it."""

    @staticmethod
    def forward(ctx, z, gamma_t, beta_t):
        ctx.save_for_backward(z, gamma_t, beta_t)
        return affine_relu_pool_forward(z, gamma_t, beta_t)

    @staticmethod
    def backward(ctx, g):
        z, gamma_t, beta_t = ctx.saved_tensors
        return affine_relu_pool_backward(z, gamma_t, beta_t, g)


def affine_relu_pool(z: torch.Tensor, gamma_t: torch.Tensor,
                     beta_t: torch.Tensor) -> torch.Tensor:
    """maxpool_3x3s2p1(relu(gamma_t * z + beta_t)) with a fused backward;
    shapes, dtypes and devices as :func:`affine_relu_pool_forward`.

    When autograd records the call it runs the autograd Function
    (forward and backward kernels on CUDA, their plain versions on the
    CPU), at any H and W; without a gradient, the forward alone."""
    needs_grad = torch.is_grad_enabled() and (
        z.requires_grad or gamma_t.requires_grad or beta_t.requires_grad)
    if needs_grad:
        return _AffineReluPool.apply(z, gamma_t, beta_t)
    return affine_relu_pool_forward(z, gamma_t, beta_t)
