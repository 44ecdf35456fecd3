// Fused ResNet stem backward for Hopper (sm_90a). For
//
//     y = relu(maxpool_3x3_s2_p1(gamma_t * z + beta_t))        (NHWC)
//
// and the gradient g of y it computes
//
//     dz        [B, H, W, C]   (z's dtype)
//     dgamma_t  [C] = sum over windows of g~ * z_win           (f32)
//     dbeta_t   [C] = sum over windows of g~                   (f32)
//
// (the f32 products summed in f64, rounded to f32 once)
//
// where g~ = g where the window's pre-ReLU max is > 0, else 0, and z_win is
// the z value at the window's winner. Any H, W >= 1 and C >= 1: g is
// [B, ceil(H/2), ceil(W/2), C], and an odd plane's last window covers one
// padding row or column. Replaces the TPU kernel `_bwd_kernel`
// (dptpu/ops/fused_stem.py), launched by `_bwd_pallas`; it computes what
// `_bwd_xla` computes, and the plain PyTorch version
// `affine_relu_pool_backward_plain` is its oracle.
//
// Bound on this card: memory. The kernel must read z and g once and write dz
// once; the work is ~30 flops per z element, far below the card's
// flops-per-byte line. At the ResNet-50 train stem, z [128,112,112,64]:
//   bf16: 205.5 MB (z) + 51.4 MB (g) + 205.5 MB (dz) = 462.4 MB -> 138.0 us
//   f32:  924.8 MB                                              -> 276.1 us
// at 3.35 TB/s.
//
// The first design (one thread = one pooled row walking its columns, one
// channel per thread) ran at 1100.4 us bf16, 12.5% of the bound, and 1552.3
// us f32 (H100 80GB HBM3 at 700 W, chip_smoke.py): 2-byte loads and stores,
// each z element loaded ~4.5 times, two 3x3 windows scanned per column, four
// windows live per thread, and each column waiting on the last.
//
// Design. A block owns a tile of kTU x kTV pooled windows of one image and
// one chunk of 128 bytes of channels (64 bf16 or 32 f32). It runs three
// phases separated by barriers:
//
//   load     the tile's z pixels, rows and columns 2u0-1 .. 2(u0+kTU)+1
//            ((2kTU+3) x (2kTV+3) pixels: the halo holds window row and
//            column u0+kTU, v0+kTV, which the +1 taps read), and the g of
//            its (kTU+1) x (kTV+1) windows, into shared memory with 16-byte
//            cp.async.cg copies (L1 bypassed). Pixels past the edge are not
//            copied: padding is decided by index.
//   A        each of the (kTU+1) x (kTV+1) windows scanned once, from shared
//            memory: its winner widx (uint8, 255 for a phantom window past
//            the last one) and g~ (in z's dtype: it is g or 0, so exact),
//            written over g in place.
//   B and C  B: each owned window's 2x2 block of dz from at most 4 taps of
//            shared memory, written with 16-byte stores. C: the affine grads
//            of the owned windows, per channel, from widx, g~ and the z
//            tile, in f64, in a fixed order.
//
// A thread owns 16 bytes of channels (8 bf16 or 4 f32): a warp's load or
// store covers 4 pixels' 128-byte chunks, and no z element leaves device
// memory more than once per tile. At 8 x 8 windows a bf16 block stages
// 19*19*128 B = 46.2 KB of z (41% of it halo, read again by the next tile
// from L2) and 64.3 KB of shared memory in all, so 3 blocks (24 warps) fit
// on an SM; the train stem gives 128*7*7 = 6,272 blocks (f32: two channel
// chunks, 12,544). Where C is not a multiple of the vector width, or z, g
// or dz is not 16-byte aligned (a view with a storage offset), the same
// kernel runs a scalar-channel instantiation (one channel a thread, same
// tiling and phases); the caller picks it.
//
// Measured at the train stem (chip_smoke.py, H100 80GB HBM3 at 700 W):
// bf16 296-311 us, 44-47% of the bound (1.49-1.56 TB/s achieved), f32
// 393-404 us, 68-70%; 75 registers a thread, no spills, 65,856 (bf16)
// and 63,264 (f32) shared bytes a block, 3 blocks (24 warps) an SM.
// What binds is no longer bytes but the SM's instruction issue: the
// window scan (a conversion, the affine, a compare, a max and a select a
// channel a tap) and phase C's winner lookup and f64 adds a channel a
// window run beside the tile copies of only 3 blocks an SM and overlap
// them little. Smaller channel chunks (more blocks an SM), 8-byte vectors,
// 512-thread blocks and taller or wider tiles all measured slower on the
// card; a load split into two cp.async groups, scanning the top half while
// the bottom lands, was slower in bf16 and faster only in f32.
//
// Determinism and accuracy. Phase C sums each channel's owned windows in
// f64: thread part p takes windows p, p+P, ..., and the parts are added in
// order into a per-tile partial [C, tiles] (caller-allocated); a second
// small kernel sums each channel's partials, contiguous, in a fixed order.
// No float atomics: every run gives the same bits. The sums run in f64: at
// the train stem a channel sums 200,704 products, and two f32 sums in
// different orders (this kernel's and the plain version's) would differ by
// far more than the 1e-4 the parity gate allows; in f64 each is the f32
// rounding of a near-exact sum of the same f32 products.
//
// Exactness against the plain version. The affine is two rounded f32 ops,
// __fadd_rn(__fmul_rn(gamma, z), beta), so no FMA contraction moves a winner.
// The 9 offsets are scanned in the order k = 3r + s with a strict `>` (the
// earlier offset keeps a tie) and a NaN-propagating max; padding taps read
// -inf (and z = 0). The ReLU mask is best > 0. The parity taps are summed in
// `_bwd_xla`'s order (dx11 = tap(0,0,2,2) + tap(0,1,2,0) + tap(1,0,0,2) +
// tap(1,1,0,0)), taps past the last window row or column read 0, then dz is
// multiplied once by gamma in f32 and rounded to z's dtype, nearest even. So
// dz equals the plain version bit for bit; the affine grads differ from it
// only in the order of their f64 sums, far below one f32 rounding.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kTU = 8, kTV = 8;                       // owned windows
constexpr int kWR = kTU + 1, kWC = kTV + 1;           // with the halo
constexpr int kZR = 2 * kTU + 3, kZC = 2 * kTV + 3;   // z tile pixels
constexpr int kThreads = 256;
constexpr int kChunkBytes = 128;                      // channels per block
constexpr int kFinalThreads = 1024;
constexpr uint8_t kPhantom = 255;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC consecutive elements of T at p (16-byte aligned when VEC > 1), as f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(*p);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "f32 vectors are 4 wide");
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 wide");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// f rounded to T (nearest even) and stored at p
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    from_float(p, f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_idx(const uint8_t* p, uint8_t (&k)[VEC]) {
  if constexpr (VEC == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k[i] = (uint8_t)(v.x >> (8 * i));
      k[4 + i] = (uint8_t)(v.y >> (8 * i));
    }
  } else if constexpr (VEC == 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) k[i] = (uint8_t)(v >> (8 * i));
  } else {
    k[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_idx(uint8_t* p,
                                          const uint8_t (&k)[VEC]) {
  if constexpr (VEC == 8) {
    uint2 v = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v.x |= (uint32_t)k[i] << (8 * i);
      v.y |= (uint32_t)k[4 + i] << (8 * i);
    }
    *reinterpret_cast<uint2*>(p) = v;
  } else if constexpr (VEC == 4) {
    uint32_t v = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) v |= (uint32_t)k[i] << (8 * i);
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    *p = k[0];
  }
}

// element i of a [C] vector of f32 (bf16 == 0) or bf16, as f32 (exact)
__device__ __forceinline__ float vector_at(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(
                    __ldg(static_cast<const __nv_bfloat16*>(p) + i))
              : __ldg(static_cast<const float*>(p) + i);
}

// jnp.maximum / torch.maximum: NaN in either operand wins (one instruction)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// One element row of VEC values, global -> shared: a 16-byte cp.async, or
// a plain copy in the scalar instantiation.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* smem, const T* gmem) {
  if constexpr (VEC == 1) {
    *smem = *gmem;
  } else {
    cp_async16(smem, gmem);
  }
}

// The shape of a launch, worked out once on the host.
struct Geo {
  int H, W, C, OH, OW;
  int tiles_u, tiles_v, chunks;
  int64_t rows;  // partial sums a channel: one per (image, tile)
  int cs;        // channels of a chunk (the shared-memory pixel stride)
  int lanes;     // threads across a chunk: cs / VEC
  int parts;     // phase C's threads a channel: threads / cs
  // shared-memory offsets in bytes (16-byte aligned), and the total
  int off_z, off_g, off_w, bytes;
};

constexpr int align16(int n) { return (n + 15) & ~15; }

template <typename T, int VEC>
Geo geo_for(int B, int H, int W, int C) {
  Geo g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.OH = (H + 1) / 2;
  g.OW = (W + 1) / 2;
  g.tiles_u = (g.OH + kTU - 1) / kTU;
  g.tiles_v = (g.OW + kTV - 1) / kTV;
  g.rows = (int64_t)B * g.tiles_u * g.tiles_v;
  const int cap = kChunkBytes / (int)sizeof(T);
  g.cs = (C < cap ? (C + VEC - 1) / VEC * VEC : cap);
  g.chunks = (C + g.cs - 1) / g.cs;
  g.lanes = g.cs / VEC;
  const int threads = kThreads / g.lanes * g.lanes;
  g.parts = threads / g.cs;
  // [2, parts, cs] f64 for phase C, then z, then g~, then widx
  g.off_z = align16(2 * g.parts * g.cs * (int)sizeof(double));
  g.off_g = g.off_z + align16(kZR * kZC * g.cs * (int)sizeof(T));
  g.off_w = g.off_g + align16(kWR * kWC * g.cs * (int)sizeof(T));
  g.bytes = g.off_w + align16(kWR * kWC * g.cs);
  return g;
}

// 3 blocks an SM is what shared memory allows at full chunks; the bound lets
// the compiler take up to 85 registers a thread for it
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
fused_stem_bwd_kernel(const T* __restrict__ z, const T* __restrict__ g,
                      const void* __restrict__ gamma,
                      const void* __restrict__ beta, int vec_bf16,
                      T* __restrict__ dz,
                      double* __restrict__ part_dg,
                      double* __restrict__ part_db, const Geo geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* red_g = reinterpret_cast<double*>(smem);
  double* red_b = red_g + geo.parts * geo.cs;
  T* zt = reinterpret_cast<T*>(smem + geo.off_z);
  T* gt = reinterpret_cast<T*>(smem + geo.off_g);
  uint8_t* wt = smem + geo.off_w;

  const int H = geo.H, W = geo.W, C = geo.C, OH = geo.OH, OW = geo.OW;
  const int cs = geo.cs;
  int blk = blockIdx.x;
  const int chunk = blk % geo.chunks;
  blk /= geo.chunks;
  const int tv = blk % geo.tiles_v;
  blk /= geo.tiles_v;
  const int tu = blk % geo.tiles_u;
  const int b = blk / geo.tiles_u;
  const int u0 = tu * kTU, v0 = tv * kTV;
  const int c0 = chunk * cs;
  const int width = min(cs, C - c0);      // channels in this chunk
  const int active = (width + VEC - 1) / VEC;
  const int lane = threadIdx.x, slot = threadIdx.y, slots = blockDim.y;
  const int tid = slot * blockDim.x + lane;
  const T* zb = z + (int64_t)b * H * W * C + c0;
  const T* gb = g + (int64_t)b * OH * OW * C + c0;
  T* dzb = dz + (int64_t)b * H * W * C + c0;

  // load: z pixels and window g's of the tile, [pixel][cs] in shared memory
  if (lane < active) {
    for (int p = slot; p < kZR * kZC; p += slots) {
      const int lr = p / kZC, lc = p - lr * kZC;
      const int ih = 2 * u0 - 1 + lr, iw = 2 * v0 - 1 + lc;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        stage<T, VEC>(zt + p * cs + lane * VEC,
                      zb + ((int64_t)ih * W + iw) * C + lane * VEC);
    }
    for (int w = slot; w < kWR * kWC; w += slots) {
      const int wu = w / kWC, wv = w - wu * kWC;
      const int u = u0 + wu, v = v0 + wv;
      if (u < OH && v < OW)
        stage<T, VEC>(gt + w * cs + lane * VEC,
                      gb + ((int64_t)u * OW + v) * C + lane * VEC);
    }
  }
  if constexpr (VEC > 1) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // the thread's channels of gamma and beta, as f32 (exact)
  float gam[VEC], bet[VEC];
  if (lane < active) {
    const int c = c0 + lane * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      gam[j] = vector_at(gamma, vec_bf16, c + j);
      bet[j] = vector_at(beta, vec_bf16, c + j);
    }
  }

  // A: every window of the tile and its halo scanned once
  if (lane < active) {
    for (int w = slot; w < kWR * kWC; w += slots) {
      const int wu = w / kWC, wv = w - wu * kWC;
      const int u = u0 + wu, v = v0 + wv;
      float gm[VEC];
      uint8_t widx[VEC];
      if (u >= OH || v >= OW) {  // a phantom window routes nothing
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          gm[j] = 0.f;
          widx[j] = kPhantom;
        }
      } else {
        float best[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) widx[j] = 0;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int ih = 2 * u - 1 + r;
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const int iw = 2 * v - 1 + s;
            const int k = 3 * r + s;
            float a[VEC];
            if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
              load_vec<T, VEC>(
                  zt + ((2 * wu + r) * kZC + 2 * wv + s) * cs + lane * VEC, a);
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                a[j] = __fadd_rn(__fmul_rn(gam[j], a[j]), bet[j]);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) a[j] = -CUDART_INF_F;
            }
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              if (k == 0) {
                best[j] = a[j];
              } else {
                if (a[j] > best[j]) widx[j] = (uint8_t)k;
                best[j] = max_nan(a[j], best[j]);
              }
            }
          }
        }
        load_vec<T, VEC>(gt + w * cs + lane * VEC, gm);
#pragma unroll
        for (int j = 0; j < VEC; ++j) gm[j] = best[j] > 0.f ? gm[j] : 0.f;
      }
      store_vec<T, VEC>(gt + w * cs + lane * VEC, gm);
      store_idx<VEC>(wt + w * cs + lane * VEC, widx);
    }
  }
  __syncthreads();

  // B: each owned window's 2x2 block of dz, gathered from <= 4 windows
  if (lane < active) {
    for (int w = slot; w < kTU * kTV; w += slots) {
      const int wu = w / kTV, wv = w - wu * kTV;
      const int u = u0 + wu, v = v0 + wv;
      if (u >= OH || v >= OW) continue;
      const int w00 = wu * kWC + wv, w01 = w00 + 1, w10 = w00 + kWC,
                w11 = w10 + 1;
      float g00[VEC], g01[VEC], g10[VEC], g11[VEC];
      uint8_t k00[VEC], k01[VEC], k10[VEC], k11[VEC];
      load_vec<T, VEC>(gt + w00 * cs + lane * VEC, g00);
      load_vec<T, VEC>(gt + w01 * cs + lane * VEC, g01);
      load_vec<T, VEC>(gt + w10 * cs + lane * VEC, g10);
      load_vec<T, VEC>(gt + w11 * cs + lane * VEC, g11);
      load_idx<VEC>(wt + w00 * cs + lane * VEC, k00);
      load_idx<VEC>(wt + w01 * cs + lane * VEC, k01);
      load_idx<VEC>(wt + w10 * cs + lane * VEC, k10);
      load_idx<VEC>(wt + w11 * cs + lane * VEC, k11);
      float d00[VEC], d01[VEC], d10[VEC], d11[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        // the parity taps, in _bwd_xla's order
        const auto tap = [](uint8_t kw, float gw, int k) {
          return kw == k ? gw : 0.f;
        };
        d00[j] = __fmul_rn(gam[j], tap(k00[j], g00[j], 4));
        d01[j] = __fmul_rn(gam[j], __fadd_rn(tap(k00[j], g00[j], 5),
                                             tap(k01[j], g01[j], 3)));
        d10[j] = __fmul_rn(gam[j], __fadd_rn(tap(k00[j], g00[j], 7),
                                             tap(k10[j], g10[j], 1)));
        d11[j] = __fmul_rn(
            gam[j], __fadd_rn(__fadd_rn(__fadd_rn(tap(k00[j], g00[j], 8),
                                                  tap(k01[j], g01[j], 6)),
                                        tap(k10[j], g10[j], 2)),
                              tap(k11[j], g11[j], 0)));
      }
      T* p0 = dzb + ((int64_t)(2 * u) * W + 2 * v) * C + lane * VEC;
      const bool col1 = 2 * v + 1 < W, row1 = 2 * u + 1 < H;
      store_vec<T, VEC>(p0, d00);
      if (col1) store_vec<T, VEC>(p0 + C, d01);
      if (row1) {
        store_vec<T, VEC>(p0 + (int64_t)W * C, d10);
        if (col1) store_vec<T, VEC>(p0 + (int64_t)W * C + C, d11);
      }
    }
  }

  // C: the owned windows' affine grads, channel by channel, in f64: part p
  // sums windows p, p + parts, ... in order
  const int ch = tid % cs, part = tid / cs;
  if (part < geo.parts) {
    double s_dg = 0.0, s_db = 0.0;
    if (ch < width) {
      for (int w = part; w < kTU * kTV; w += geo.parts) {
        const int wu = w / kTV, wv = w - wu * kTV;
        const int u = u0 + wu, v = v0 + wv;
        if (u >= OH || v >= OW) continue;
        const int wi = wu * kWC + wv;
        const int k = wt[wi * cs + ch];
        const float gm = to_float(gt[wi * cs + ch]);
        const int r = (k * 11) >> 5, s = k - 3 * r;  // k / 3 for k < 9
        // only a window on the plane's edge has taps in the padding
        const bool edge = u == 0 || v == 0 || 2 * u + 1 >= H || 2 * v + 1 >= W;
        const int ih = 2 * u - 1 + r, iw = 2 * v - 1 + s;
        const float zwin =
            (!edge || (ih >= 0 && ih < H && iw >= 0 && iw < W))
                ? to_float(zt[((2 * wu * kZC + 2 * wv) + k + (kZC - 3) * r) *
                                  cs + ch])
                : 0.f;
        s_dg += (double)__fmul_rn(gm, zwin);
        s_db += (double)gm;
      }
    }
    red_g[part * cs + ch] = s_dg;
    red_b[part * cs + ch] = s_db;
  }
  __syncthreads();
  if (part == 0 && ch < width) {
    double s_dg = 0.0, s_db = 0.0;
    for (int p = 0; p < geo.parts; ++p) {
      s_dg += red_g[p * cs + ch];
      s_db += red_b[p * cs + ch];
    }
    const int64_t row = blockIdx.x / geo.chunks;
    part_dg[(int64_t)(c0 + ch) * geo.rows + row] = s_dg;
    part_db[(int64_t)(c0 + ch) * geo.rows + row] = s_db;
  }
}

// One block per channel: thread t sums partials t, t + 1024, ... in order,
// then a fixed tree over the block's threads; one rounding to f32 at the end.
__global__ void __launch_bounds__(kFinalThreads)
fused_stem_bwd_finalize(const double* __restrict__ part_dg,
                        const double* __restrict__ part_db,
                        float* __restrict__ dgamma, float* __restrict__ dbeta,
                        int nrows) {
  __shared__ double sdg[kFinalThreads];
  __shared__ double sdb[kFinalThreads];
  const int c = blockIdx.x;
  double s_dg = 0.0, s_db = 0.0;
  for (int j = threadIdx.x; j < nrows; j += kFinalThreads) {
    s_dg += part_dg[(int64_t)c * nrows + j];
    s_db += part_db[(int64_t)c * nrows + j];
  }
  sdg[threadIdx.x] = s_dg;
  sdb[threadIdx.x] = s_db;
  __syncthreads();
  for (int stride = kFinalThreads / 2; stride > 0; stride >>= 1) {
    if ((int)threadIdx.x < stride) {
      sdg[threadIdx.x] += sdg[threadIdx.x + stride];
      sdb[threadIdx.x] += sdb[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dgamma[c] = (float)sdg[0];
    dbeta[c] = (float)sdb[0];
  }
}

bool shape_ok(int B, int H, int W, int C) {
  return B > 0 && H > 0 && W > 0 && C > 0;
}

dim3 block_for(const Geo& geo) {
  return dim3(geo.lanes, kThreads / geo.lanes);
}

// Lets the kernel take the shared memory of a full chunk, the most any
// shape needs (one value, so launches from several threads cannot race),
// once per device: the call costs the host tens of microseconds.
template <typename T, int VEC>
cudaError_t allow_shared_memory() {
  static std::atomic<uint64_t> allowed{0};  // bit d: device d is done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (allowed.load() & bit) return cudaSuccess;
  const Geo full = geo_for<T, VEC>(1, 2, 2, kChunkBytes);
  err = cudaFuncSetAttribute(fused_stem_bwd_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             full.bytes);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

template <typename T, int VEC>
int launch(const void* z, const void* g, const void* gamma,
           const void* beta, int vec_bf16, void* dz, double* partials,
           float* dgb, int B, int H, int W, int C, cudaStream_t stream) {
  const Geo geo = geo_for<T, VEC>(B, H, W, C);
  const int64_t blocks = geo.rows * geo.chunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = allow_shared_memory<T, VEC>();
  if (err != cudaSuccess) return (int)err;
  double* part_dg = partials;
  double* part_db = partials + geo.rows * C;
  fused_stem_bwd_kernel<T, VEC>
      <<<(unsigned)blocks, block_for(geo), geo.bytes, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(g), gamma, beta,
      vec_bf16, static_cast<T*>(dz), part_dg, part_db, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_stem_bwd_finalize<<<C, kFinalThreads, 0, stream>>>(
      part_dg, part_db, dgb, dgb + C, (int)geo.rows);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator say of one instantiation
// at channel count C: out = {registers a thread, local (spill) bytes a
// thread, shared bytes a block, threads a block, resident blocks an SM}.
template <typename T, int VEC>
int attrs(int C, int* out) {
  const Geo geo = geo_for<T, VEC>(1, 2, 2, C);
  const auto kernel = fused_stem_bwd_kernel<T, VEC>;
  cudaError_t err = allow_shared_memory<T, VEC>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 block = block_for(geo);
  const int threads = (int)(block.x * block.y);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      threads, geo.bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes + geo.bytes;
  out[3] = threads;
  out[4] = resident;
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// The rows of each of the two [C, rows] f64 partial-sum buffers the caller
// allocates (0 for a shape the kernel does not take).
extern "C" int dptpu_fused_stem_bwd_blocks(int B, int H, int W, int C) {
  if (!shape_ok(B, H, W, C)) return 0;
  const int64_t rows = geo_for<float, 4>(B, H, W, C).rows;  // any T, VEC
  return rows > 0x7fffffff ? 0 : (int)rows;
}

// dtype: 0 = float32, 1 = bfloat16; vec: 1 = 16-byte channel vectors (C a
// multiple of 4 for f32 or 8 for bf16, and z, g, dz 16-byte aligned), 0 =
// one channel a thread; vdtype: the dtype of gamma/beta, 0 = float32, 1 =
// bfloat16. z and dz are [B, H, W, C] contiguous, g is [B, ceil(H/2),
// ceil(W/2), C] contiguous, all of z's dtype; gamma/beta are [C]
// contiguous; partials is [2, C, rows] float64 scratch (rows from
// dptpu_fused_stem_bwd_blocks); dgb receives dgamma_t then dbeta_t, [2, C]
// float32.
extern "C" int dptpu_fused_stem_bwd(int dtype, int vec, int vdtype,
                                    const void* z, const void* g,
                                    const void* gamma, const void* beta,
                                    void* dz, void* partials, void* dgb,
                                    int B, int H, int W, int C,
                                    void* stream) {
  if (!shape_ok(B, H, W, C) || (vdtype != 0 && vdtype != 1))
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned16(z) && aligned16(g) && aligned16(dz) &&
               C % (dtype == 0 ? 4 : 8) == 0))
    return (int)cudaErrorMisalignedAddress;
  double* part = static_cast<double*>(partials);
  float* out = static_cast<float*>(dgb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    return launch<float, 4>(z, g, gamma, beta, vdtype, dz, part, out, B, H,
                            W, C, s);
  if (dtype == 0)
    return launch<float, 1>(z, g, gamma, beta, vdtype, dz, part, out, B, H,
                            W, C, s);
  if (dtype == 1 && vec)
    return launch<__nv_bfloat16, 8>(z, g, gamma, beta, vdtype, dz, part, out,
                                    B, H, W, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 1>(z, g, gamma, beta, vdtype, dz, part, out,
                                    B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// Registers, spills, shared memory, threads and resident blocks of the
// instantiation (dtype, vec) at channel count C, into out[5]; returns a
// cudaError_t.
extern "C" int dptpu_fused_stem_bwd_attrs(int dtype, int vec, int C,
                                          void* out) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  if (dtype == 0) return vec ? attrs<float, 4>(C, o) : attrs<float, 1>(C, o);
  if (dtype == 1)
    return vec ? attrs<__nv_bfloat16, 8>(C, o) : attrs<__nv_bfloat16, 1>(C, o);
  return (int)cudaErrorInvalidValue;
}
