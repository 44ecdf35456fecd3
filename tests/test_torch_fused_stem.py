"""The port's fused stem (dptpu_torch/ops/fused_stem.py) against the JAX
reference (dptpu/ops/fused_stem.py): the plain PyTorch forward and
backward against ``_fwd_xla``/``_bwd_xla`` and against the Pallas kernels
in interpret mode, and the autograd op against ``jax.vjp``.

Forward, against ``_fwd_xla`` and the public JAX op: bitwise. Both round
``gamma_t * z`` and ``+ beta_t`` as two separate f32 operations, the max
is exact, and the bf16 output cast rounds to nearest even on both.
Against the Pallas kernel in interpret mode: the FMA bound stated in its
test.

Backward, against ``_bwd_xla``: ``dz`` bitwise (the same winner scan,
the same parity-tap sums in the same order, one multiply by gamma_t);
``dgamma_t``/``dbeta_t`` within the JAX test's own tolerance (rtol 1e-5,
atol 1e-4), since the pooled-grid sums run in another order. Against
``_bwd_pallas(interpret=True)`` on bf16 tie-heavy inputs: ``dz``
bitwise, because bf16 products are exact in f32, so interpret mode's FMA
cannot move a winner there.

The CUDA kernels are held to the same plain versions, bit for bit in
``y`` and ``dz``, on the card by chip_smoke.py.
"""

import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dptpu.ops import fused_stem as jfs
from dptpu_torch.kernels import build
from dptpu_torch.ops import fused_stem as tfs

_DTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, shape, ties=False, negative_gamma=False):
    rng = np.random.RandomState(seed)
    z = rng.randn(*shape).astype(np.float32)
    if ties:
        z = np.round(z * 2) / 2  # many equal window values, incl. zeros
    c = shape[-1]
    gam = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    if negative_gamma:
        gam[::3] *= -1.0  # a negative scale flips the window's order
    bet = (rng.randn(c) * 0.1).astype(np.float32)
    return z, gam, bet


def _both(z, gam, bet, dtype):
    tdt, jdt = _DTYPES[dtype]
    zt = torch.from_numpy(z).to(tdt)
    zj = jnp.asarray(z).astype(jdt)
    return ((zt, torch.from_numpy(gam), torch.from_numpy(bet)),
            (zj, jnp.asarray(gam), jnp.asarray(bet)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h", [8, 32])
def test_plain_matches_jax_xla_bitwise(h, dtype):
    z, gam, bet = _inputs(h, (2, h, h, 64))
    t_args, j_args = _both(z, gam, bet, dtype)
    y = tfs.affine_relu_pool_plain(*t_args)
    assert y.dtype == t_args[0].dtype and y.is_contiguous()
    assert tuple(y.shape) == (2, h // 2, h // 2, 64)
    np.testing.assert_array_equal(_np(y), _np(jfs._fwd_xla(*j_args)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h", [8, 32])
def test_plain_vs_pallas_interpret_within_the_fma_bound(h, dtype):
    """Interpret mode evaluates ``_fwd_kernel``'s affine as ONE fused
    multiply-add, while ``_fwd_xla`` rounds twice like the port (the
    bitwise form of this test fails here, off by ulps). The two roundings
    differ by at most half an ulp of ``gamma_t * z`` plus an ulp of the
    result: |Δ| <= 2**-23 * max|gamma_t * z| in f32, and one more bf16
    rounding (rtol 2**-7) in bf16."""
    z, gam, bet = _inputs(h, (2, h, h, 64))
    t_args, j_args = _both(z, gam, bet, dtype)
    y = _np(tfs.affine_relu_pool_plain(*t_args))
    ref = _np(jfs._fwd_pallas(*j_args, interpret=True))
    zq = t_args[0].float().numpy()
    atol = 2.0 ** -23 * float(np.abs(gam * zq).max())
    np.testing.assert_allclose(y, ref, atol=atol,
                               rtol=2.0 ** -7 if dtype == "bf16" else 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 32, 32, 64),
                                   (1, 7, 9, 64), (2, 5, 5, 3)])
def test_ties_and_negative_gamma_match_public_jax_op(shape, dtype):
    """Tie-heavy input, negative gammas, even and odd shapes and an odd
    channel count, through both public ops (JAX takes its plain
    composition for odd dims, the port's op takes its plain version on
    the CPU)."""
    z, gam, bet = _inputs(7, shape, ties=True, negative_gamma=True)
    t_args, j_args = _both(z, gam, bet, dtype)
    y = tfs.affine_relu_pool(*t_args)
    ref = jfs.affine_relu_pool(*j_args)
    assert tuple(y.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(_np(y), _np(ref))


def test_channels_last_view_is_taken_without_a_copy():
    """Inside the ResNet the stem output is a channels_last NCHW tensor and
    its permute(0, 2, 3, 1) view is NHWC-contiguous: the op's input
    contract holds without a copy."""
    x = torch.randn(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    z = x.permute(0, 2, 3, 1)
    assert z.is_contiguous() and z.data_ptr() == x.data_ptr()
    gam, bet = torch.ones(64), torch.zeros(64)
    y = tfs.affine_relu_pool(z, gam, bet)
    ref = tfs.affine_relu_pool_plain(z.contiguous(), gam, bet)
    assert torch.equal(y, ref)


def test_cpu_takes_the_plain_path_and_counts_no_launch():
    z, gam, bet = _inputs(3, (2, 8, 8, 64))
    before = tfs.affine_relu_pool_forward.launches
    y = tfs.affine_relu_pool(torch.from_numpy(z), torch.from_numpy(gam),
                             torch.from_numpy(bet))
    assert tfs.affine_relu_pool_forward.launches == before
    assert torch.equal(y, tfs.affine_relu_pool_plain(
        torch.from_numpy(z), torch.from_numpy(gam), torch.from_numpy(bet)))


def test_non_cpu_tensor_without_a_kernel_raises():
    """A tensor off the CPU reaches only a kernel: a device the port has no
    kernel for raises instead of falling back to the plain version."""
    z = torch.empty((2, 8, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfs.affine_relu_pool(z, torch.ones(64), torch.zeros(64))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel build has no fallback: no nvcc means an error that says
    where it looked, and nothing is written."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "CUDA_ROOTS", ())
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_library_name_follows_the_sources():
    assert [p.name for p in build.sources()] == [
        "fused_stem_bwd.cu", "fused_stem_fwd.cu", "probe_mosaic.cu",
        "probe_mosaic2.cu"]
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name == f"libdptpu_torch_{build.source_hash()}.so"


# -- the backward ----------------------------------------------------------

def _grad_inputs(seed, shape, ties, negative_gamma):
    z, gam, bet = _inputs(seed, shape, ties=ties,
                          negative_gamma=negative_gamma)
    rng = np.random.RandomState(seed + 100)
    g = rng.randn(shape[0], shape[1] // 2, shape[2] // 2,
                  shape[3]).astype(np.float32)
    if ties:
        g[0, 0, 0, :8] = -0.0  # signed zeros must route as they do in JAX
    return z, gam, bet, g


def _assert_bwd_matches(got, ref):
    dz, dg, db = got
    rdz, rdg, rdb = ref
    np.testing.assert_array_equal(_np(dz).view(np.uint32),
                                  _np(rdz).view(np.uint32))
    for a, b in ((dg, rdg), (db, rdb)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("negative_gamma", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h", [8, 32])
def test_plain_backward_matches_jax_xla(h, dtype, ties, negative_gamma):
    z, gam, bet, g = _grad_inputs(h, (2, h, h, 64), ties, negative_gamma)
    tdt, jdt = _DTYPES[dtype]
    (zt, gt, bt), (zj, gj, bj) = _both(z, gam, bet, dtype)
    # the affine in the model's compute dtype, as FusedBNReLUPool passes it
    got = tfs.affine_relu_pool_backward_plain(
        zt, gt.to(tdt), bt.to(tdt), torch.from_numpy(g).to(tdt))
    ref = jfs._bwd_xla(zj, gj.astype(jdt), bj.astype(jdt),
                       jnp.asarray(g).astype(jdt))
    assert tuple(got[0].shape) == z.shape and got[1].dtype == tdt
    _assert_bwd_matches(got, ref)


@pytest.mark.parametrize("h", [8, 32])
def test_plain_backward_matches_pallas_interpret_on_bf16_ties(h):
    """The JAX test's own bf16 tie inputs (tests/test_fused_stem.py): at
    h = 32 the Pallas kernel's +1-row chunk overlap must count each window
    row once, and the port has no chunks at all."""
    rng = np.random.RandomState(2)
    z = np.round(rng.randn(2, h, h, 64) * 2) / 2
    gam = rng.randn(64) * 0.5 + 1.0
    bet = rng.randn(64) * 0.1
    g = rng.randn(2, h // 2, h // 2, 64)
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (z, gam, bet, g)]
    args_t = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
              for a in (z, gam, bet, g)]
    _assert_bwd_matches(tfs.affine_relu_pool_backward_plain(*args_t),
                        jfs._bwd_pallas(*args_j, interpret=True))


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 12, 12, 8),
                                   (1, 7, 7, 4), (1, 7, 10, 8)])
def test_autograd_op_matches_jax_vjp(shape):
    """The public op under autograd against ``jax.vjp`` of the public JAX
    op. The port's op takes the fused backward at every size; the JAX op
    differentiates its plain composition on odd dims (XLA's
    select_and_scatter), so the odd shapes hold the gather against it."""
    z, gam, bet = _inputs(11, shape, ties=True, negative_gamma=True)
    rng = np.random.RandomState(12)
    oh, ow = (shape[1] + 1) // 2, (shape[2] + 1) // 2
    g = rng.randn(shape[0], oh, ow, shape[3]).astype(np.float32)
    y_ref, vjp = jax.vjp(jfs.affine_relu_pool, jnp.asarray(z),
                         jnp.asarray(gam), jnp.asarray(bet))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (z, gam, bet)]
    y = tfs.affine_relu_pool(*leaves)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(y.detach()), _np(y_ref))
    for leaf, ref in zip(leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), _np(ref),
                                   rtol=1e-5, atol=1e-4)


def test_backward_saves_its_inputs_not_the_output():
    z, gam, bet = _inputs(13, (2, 8, 8, 64))
    zt = torch.from_numpy(z).requires_grad_(True)
    y = tfs.affine_relu_pool(zt, torch.from_numpy(gam), torch.from_numpy(bet))
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and saved[0].data_ptr() == zt.data_ptr()
    assert all(t.data_ptr() != y.data_ptr() for t in saved)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 15, 15, 16),
                                   (1, 7, 10, 16)])
def test_every_plane_takes_the_fused_backward(shape):
    """Even and odd planes alike record the autograd Function, so a CUDA
    tensor of any size launches both kernels (an odd ``--image-size``
    stem, 30 -> 15, no longer trains through plain PyTorch)."""
    z, gam, bet = _inputs(17, shape)
    zt = torch.from_numpy(z).requires_grad_(True)
    y = tfs.affine_relu_pool(zt, torch.from_numpy(gam), torch.from_numpy(bet))
    assert type(y.grad_fn).__name__ == "_AffineReluPoolBackward"
    y.sum().backward()
    assert zt.grad.shape == zt.shape


def test_cpu_backward_takes_the_plain_path_and_counts_no_launch():
    z, gam, bet, g = _grad_inputs(14, (2, 8, 8, 64), False, False)
    args = [torch.from_numpy(a) for a in (z, gam, bet, g)]
    before = (tfs.affine_relu_pool_backward.launches,
              tfs.affine_relu_pool_backward.g_copies)
    got = tfs.affine_relu_pool_backward(*args)
    assert (tfs.affine_relu_pool_backward.launches,
            tfs.affine_relu_pool_backward.g_copies) == before
    for a, b in zip(got, tfs.affine_relu_pool_backward_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ceil"):
        tfs.affine_relu_pool_backward_plain(
            torch.zeros(1, 7, 8, 4), torch.ones(4), torch.zeros(4),
            torch.zeros(1, 3, 4, 4))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 7, 7, 16), (1, 9, 6, 8),
                                   (2, 1, 5, 4), (2, 15, 15, 64)])
def test_plain_backward_on_odd_planes_matches_autograd(shape, dtype):
    """Odd planes, which ``_bwd_xla`` does not take: the gather against
    autograd of the plain composition (max_pool2d's own backward, which
    adds a pixel's <= 4 window grads in the same order), with ties and
    negative gammas: ``dz`` bitwise, the affine grads within the JAX
    test's tolerance."""
    tdt = _DTYPES[dtype][0]
    z, gam, bet = _inputs(15, shape, ties=True, negative_gamma=True)
    rng = np.random.RandomState(16)
    g = rng.randn(shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2,
                  shape[3]).astype(np.float32)
    zt, gt, bt, got_g = (torch.from_numpy(a).to(tdt) for a in (z, gam, bet, g))
    leaves = [t.clone().requires_grad_(True) for t in (zt, gt, bt)]
    tfs.affine_relu_pool_plain(*leaves).backward(got_g)
    got = tfs.affine_relu_pool_backward_plain(zt, gt, bt, got_g)
    assert got[0].shape == zt.shape and got[0].is_contiguous()
    assert all(a.dtype == tdt for a in got)
    _assert_bwd_matches(got, [leaf.grad for leaf in leaves])


# -- the shapes the backward kernel's code paths take -----------------------
# The kernel tiles the pooled plane in 8 x 8 windows and the channels in
# 16-byte vectors; these channel counts leave a vector tail (24, 72), fill
# one vector (8) or take the scalar-channel instantiation (3), and these
# planes' pooled sizes (9 x 9, 5 x 15, 9 x 9 and 5 x 15 odd) are no
# multiple of the tile. The plain version is held to JAX there; on the
# card chip_smoke.py holds the kernel to the plain version at such shapes.
_PATH_CHANNELS = [3, 8, 24, 72]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", _PATH_CHANNELS)
@pytest.mark.parametrize("plane", [(18, 18), (10, 30)])
def test_plain_backward_matches_jax_xla_at_kernel_path_shapes(plane, c, dtype,
                                                              ties):
    """Even planes: against ``_bwd_xla``, ``dz`` bitwise and the affine
    grads within the JAX test's tolerance, negative gammas included."""
    shape = (2, *plane, c)
    z, gam, bet, g = _grad_inputs(sum(shape), shape, ties, True)
    tdt, jdt = _DTYPES[dtype]
    (zt, gt, bt), (zj, gj, bj) = _both(z, gam, bet, dtype)
    got = tfs.affine_relu_pool_backward_plain(
        zt, gt.to(tdt), bt.to(tdt), torch.from_numpy(g).to(tdt))
    ref = jfs._bwd_xla(zj, gj.astype(jdt), bj.astype(jdt),
                       jnp.asarray(g).astype(jdt))
    _assert_bwd_matches(got, ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", _PATH_CHANNELS)
@pytest.mark.parametrize("plane", [(17, 17), (9, 29)])
def test_plain_backward_matches_jax_vjp_on_odd_kernel_path_shapes(plane, c,
                                                                  dtype):
    """Odd planes, where the JAX op differentiates its plain composition:
    against ``jax.vjp`` of ``affine_relu_pool`` on tie-heavy input with
    negative gammas, ``dz`` bitwise and the affine grads within the JAX
    test's tolerance. (g carries no -0.0 here: the composition's
    scatter-add starts from +0, the gather keeps a lone -0.0.)"""
    shape = (2, *plane, c)
    z, gam, bet = _inputs(sum(shape), shape, ties=True, negative_gamma=True)
    rng = np.random.RandomState(sum(shape) + 1)
    g = rng.randn(2, (plane[0] + 1) // 2, (plane[1] + 1) // 2,
                  c).astype(np.float32)
    tdt, jdt = _DTYPES[dtype]
    (zt, gt, bt), (zj, gj, bj) = _both(z, gam, bet, dtype)
    gj, bj = gj.astype(jdt), bj.astype(jdt)
    _, vjp = jax.vjp(jfs.affine_relu_pool, zj, gj, bj)
    ref = vjp(jnp.asarray(g).astype(jdt))
    got = tfs.affine_relu_pool_backward_plain(
        zt, gt.to(tdt), bt.to(tdt), torch.from_numpy(g).to(tdt))
    _assert_bwd_matches(got, ref)


# -- the shapes the forward kernel's code paths take ------------------------
# The forward kernel tiles the pooled plane in 8 x 8 windows too, in pairs of
# rows, with the same channel vectors: the same channel counts reach its
# vector tails and scalar instantiation, and these planes (9 x 9, 5 x 15
# pooled; odd 9 x 9 and 5 x 15 with a padding row or column) are no
# multiple of its tile or of its window pairs.


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", _PATH_CHANNELS)
@pytest.mark.parametrize("plane", [(18, 18), (10, 30)])
def test_plain_forward_matches_jax_xla_at_kernel_path_shapes(plane, c, dtype,
                                                             ties):
    """Even planes: against ``_fwd_xla``, bitwise, negative gammas, with
    gamma/beta in the compute dtype as the model passes them."""
    shape = (2, *plane, c)
    z, gam, bet = _inputs(sum(shape), shape, ties=ties, negative_gamma=True)
    tdt, jdt = _DTYPES[dtype]
    (zt, gt, bt), (zj, gj, bj) = _both(z, gam, bet, dtype)
    y = tfs.affine_relu_pool_plain(zt, gt.to(tdt), bt.to(tdt))
    ref = jfs._fwd_xla(zj, gj.astype(jdt), bj.astype(jdt))
    assert y.dtype == tdt and tuple(y.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(_np(y), _np(ref))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", _PATH_CHANNELS)
@pytest.mark.parametrize("plane", [(17, 17), (9, 29)])
def test_plain_forward_matches_public_jax_op_on_odd_kernel_path_shapes(
        plane, c, dtype):
    """Odd planes, where the JAX op takes its plain composition: the
    port's public op (its plain version on the CPU) bitwise against it, on
    tie-heavy input with negative gammas."""
    shape = (2, *plane, c)
    z, gam, bet = _inputs(sum(shape) + 1, shape, ties=True,
                          negative_gamma=True)
    tdt, jdt = _DTYPES[dtype]
    (zt, gt, bt), (zj, gj, bj) = _both(z, gam, bet, dtype)
    y = tfs.affine_relu_pool(zt, gt.to(tdt), bt.to(tdt))
    ref = jfs.affine_relu_pool(zj, gj.astype(jdt), bj.astype(jdt))
    assert tuple(y.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(_np(y), _np(ref))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 18, 18, 24), (1, 7, 9, 64)])
def test_forward_takes_bf16_gamma_beta_as_their_f32_values(shape, dtype):
    """The kernels read gamma_t/beta_t in f32 or bf16 as they come and
    widen them exactly; so does the wrapper's CPU path: the same values
    give bitwise the same ``y`` in either dtype."""
    tdt = _DTYPES[dtype][0]
    z, gam, bet = _inputs(sum(shape) + 2, shape, ties=True,
                          negative_gamma=True)
    zt = torch.from_numpy(z).to(tdt)
    gb, bb = (torch.from_numpy(a).bfloat16() for a in (gam, bet))
    y_bf16 = tfs.affine_relu_pool_forward(zt, gb, bb)
    y_f32 = tfs.affine_relu_pool_forward(zt, gb.float(), bb.float())
    assert y_bf16.dtype == y_f32.dtype == tdt
    assert torch.equal(y_bf16, y_f32)


@pytest.mark.parametrize("dtype,c,offset,want", [
    (torch.float32, 64, 0, True), (torch.bfloat16, 64, 0, True),
    (torch.float32, 6, 0, False), (torch.bfloat16, 12, 0, False),
    (torch.bfloat16, 64, 1, False),
])
def test_vectorized_needs_whole_vectors_and_aligned_pointers(dtype, c,
                                                             offset, want):
    """The wrapper's pick of the kernels' instantiation: 16-byte channel
    vectors need C a multiple of the vector width and every tensor 16-byte
    aligned; a view one element into its storage is not."""
    flat = torch.zeros(2 * 4 * 4 * c + offset, dtype=dtype)
    z = flat[offset:].view(2, 4, 4, c)
    y = torch.zeros(2, 2, 2, c, dtype=dtype)
    assert tfs.vectorized(z, y) is want


# -- the kernels' C interface -----------------------------------------------

_EXTERN_C = re.compile(r'extern "C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')


def _extern_c_functions():
    """``(name, [is_pointer, ...])`` of every ``extern "C"`` function of
    ``dptpu_torch/csrc/*.cu``, parsed from the sources."""
    out = []
    for src in build.sources():
        for ret, name, params in _EXTERN_C.findall(src.read_text()):
            assert ret == "int", f"{src.name}: {name} returns {ret}"
            args = [p.strip() for p in params.split(",") if p.strip()]
            out.append((name, ["*" in a for a in args]))
    return out


class _FakeLibrary:
    """Stands in for the built library: records what ``load_library``
    declares on each entry point."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def declared_library(monkeypatch):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", lambda: build.BUILD_DIR / "lib.so")
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLibrary)
    return build.load_library()


@pytest.mark.parametrize("name,pointers", _extern_c_functions(),
                         ids=[n for n, _ in _extern_c_functions()])
def test_every_entry_point_has_its_ctypes_signature(declared_library, name,
                                                    pointers):
    """Every ``extern "C"`` function gets ``argtypes`` and ``restype``
    before it can be called: one argument type a parameter, each pointer
    (and the stream) as ``c_void_p`` so no address is cut to 32 bits, each
    int as ``c_int``."""
    fn = getattr(declared_library, name)
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [ctypes.c_void_p if p else ctypes.c_int
                           for p in pointers]
