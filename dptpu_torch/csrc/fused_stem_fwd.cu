// Fused ResNet stem forward for Hopper (sm_90a):
//
//     y = relu(maxpool_3x3_s2_p1(gamma_t * z + beta_t))        (NHWC)
//
// Replaces the TPU kernel `_fwd_kernel` (dptpu/ops/fused_stem.py), launched
// by `_fwd_pallas`. gamma_t/beta_t are the BN affine with the running
// statistics folded in, in f32 or bf16 (converted to f32 here, exactly); the
// affine and the 3x3 window max run in f32 and the result is cast to z's
// dtype (f32 or bf16). Any H, W >= 1 and C >= 1. The 112x112 ReLU plane is
// never written: z is read, y is written, nothing else touches device memory.
//
// Bound on this card: memory. At the ResNet-50 train stem, z
// [128,112,112,64] bf16, the kernel must read 205.5 MB and write 51.4 MB
// (76.7 us at 3.35 TB/s; f32 at serve batch 64 the same bytes), against ~13
// flops per output element, far below the card's flops-per-byte line.
//
// The first design (one thread = one pooled row walking its 56 columns, one
// channel a thread) ran at 191.0 us in bf16 at the train stem, 40.1% of the
// bound, and 114.2 us in f32 at serve batch 64 (H100 80GB HBM3 at 700 W,
// chip_smoke.py). What held it back: 2-byte loads and stores in bf16 (a warp
// instruction moved 64 bytes), a serial walk with at most 6 loads in flight a
// thread, input rows 2*oh +- 1 read by two threads of often different blocks,
// and at serving sizes too few blocks (B x 14) for 132 SMs.
//
// Design. A block owns a tile of kTU x kTV = 4 x 8 pooled windows of one
// image and one chunk of 128 bytes of channels (64 bf16 or 32 f32): 12,544
// blocks at the train stem, 3,136 in f32 at serve batch 16. A thread owns 16
// bytes of channels (8 bf16 or 4 f32) and two vertically adjacent windows of
// one column, 15 input pixels: it takes each input row's max over the
// window's 3 columns, then each window's max over its 3 rows, so the row the
// two windows share is converted and scaled once. A warp covers 4
// neighbouring columns, so each of its 16-byte loads moves 4 whole 128-byte
// lines. Where the taps come from depends on the dtype, as measured:
//
//   f32   the block first copies its tile's 9 x 17 pixels (19.6 KB) to
//         shared memory with 16-byte cp.async.cg, then computes from there.
//         The copies hold no registers, so 8 blocks an SM (at <= 64
//         registers) keep their tiles in flight.
//   bf16  twice the arithmetic a byte: the thread issues its 15 taps'
//         16-byte loads (ld.global.nc) at once into registers (128 a thread,
//         4 blocks an SM) and takes the neighbours' shared pixels from L1;
//         with no barrier each warp's arithmetic overlaps the others' loads.
//
// Staged, bf16 measured slower at the train stem (4 channels a thread, and
// more so 8, whose registers spilled); unstaged, f32 measured slower at
// serve batch 64 (PERF.md).
//
// Each z byte leaves device memory about once; the tile's halo row and
// column come a second time from L2. Where C is not a multiple of the vector
// width, or z or y is not 16-byte aligned (a view with a storage offset),
// the same kernel runs a scalar-channel instantiation (one channel a thread,
// same tiling); the caller picks it, and the entry refuses a vector launch
// it cannot take.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, device time from the
// card's kernel records): bf16 train stem 100.8 us, 76.0% of the bound
// (2.55 TB/s); f32 serve batch 64 88.1 us, 87.1%; bf16 serve batch 64 52.7
// us; f32 serve batch 16 26.0 us. What binds now: in f32 the bytes (87-90%
// of the bound at batch 64 and 128). In bf16 the thread's registers: the 15
// taps in flight take 128 registers (16 spill bytes), which leaves 4 blocks
// (16 warps) an SM; fewer registers (staged copies) moved the arithmetic
// behind a barrier and measured slower.
//
// Exactness. The plain PyTorch version rounds gamma_t*z and +beta_t as two
// separate operations; nvcc would contract a*b+c into an FMA, so the affine
// is written with __fmul_rn/__fadd_rn. The max is exact and propagates NaN
// (max.NaN.f32, as jnp.maximum and max_pool2d do), out-of-range taps are
// -inf as XLA's reduce_window pads, the ReLU maps every non-positive value
// (and NaN) to +0 exactly as the plain version's where(pooled > 0, pooled, 0),
// and the bf16 store rounds to nearest even like torch's cast: the kernel
// equals the plain version bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTU = 4, kTV = 8;                      // pooled windows
constexpr int kZR = 2 * kTU + 1, kZC = 2 * kTV + 1;  // z tile pixels
constexpr int kPairs = kTU / 2 * kTV;  // a thread's unit: 2 windows, 1 column
constexpr int kThreads = 128;
constexpr int kChunkBytes = 128;       // channels per block

// Where a thread's taps come from: f32 copies its block's tile to shared
// memory first; bf16 loads its 15 taps straight into registers. Each is the
// faster of the two for its dtype on the card (the note at the head).
template <typename T>
__host__ __device__ constexpr bool staged() {
  return std::is_same<T, float>::value;
}

// resident blocks an SM to allow for: the register bound a thread
template <typename T>
__host__ __device__ constexpr int min_blocks() {
  return staged<T>() ? 8 : 4;
}

// VEC elements of T as they sit in memory: one T, or 16 bytes
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& v,
                                       float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same<T, float>::value) {
      f[0] = v;
    } else {
      f[0] = __bfloat162float(v);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "f32 vectors are 4 wide");
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 wide");
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// f rounded to T (nearest even) and stored at p (16-byte aligned if VEC > 1)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same<T, float>::value) {
      *p = f[0];
    } else {
      *p = __float2bfloat16_rn(f[0]);
    }
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

// VEC elements global -> shared: a 16-byte cp.async (L1 bypassed), or a
// plain copy in the scalar instantiation
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* smem, const T* gmem) {
  if constexpr (VEC == 1) {
    *smem = *gmem;
  } else {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  }
}

// The shape of a launch, worked out once on the host.
struct Geo {
  int H, W, C, OH, OW;
  int tiles_u, tiles_v, chunks;
  int cs;     // channels of a chunk (the shared-memory pixel stride)
  int lanes;  // threads across a chunk: cs / VEC
  int slots;  // threads across the tile's window pairs
  int bytes;  // shared memory a block
};

template <typename T, int VEC>
Geo geo_for(int H, int W, int C) {
  Geo g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.OH = (H + 1) / 2;
  g.OW = (W + 1) / 2;
  g.tiles_u = (g.OH + kTU - 1) / kTU;
  g.tiles_v = (g.OW + kTV - 1) / kTV;
  const int cap = kChunkBytes / (int)sizeof(T);
  g.cs = (C < cap ? (C + VEC - 1) / VEC * VEC : cap);
  g.chunks = (C + g.cs - 1) / g.cs;
  g.lanes = g.cs / VEC;
  const int slots = kThreads / g.lanes;
  g.slots = slots < kPairs ? slots : kPairs;
  g.bytes = staged<T>() ? kZR * kZC * g.cs * (int)sizeof(T) : 0;
  return g;
}

// A block owns a tile of windows and a chunk of channels; a thread owns
// VEC channels and window pairs of one column: the 5 input rows of a pair
// are 2u-1 .. 2u+3, rows 0-2 make window u and rows 2-4 window u+1. Staged,
// the block first copies the tile's z pixels, rows and columns 2u0-1 ..
// 2(u0+kTU)-1, to shared memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
fused_stem_fwd_kernel(const T* __restrict__ z, const void* __restrict__ gamma,
                      const void* __restrict__ beta, int vec_bf16,
                      T* __restrict__ y, const Geo geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* zt = reinterpret_cast<T*>(smem);
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
  const int lane = threadIdx.x, slot = threadIdx.y, slots = blockDim.y;
  const int c = chunk * cs + lane * VEC;
  const bool active = c < C;  // not an idle lane of a tail chunk
  const T* zb = z + (int64_t)b * H * W * C + c;

  if constexpr (staged<T>()) {  // the tile, [pixel][cs]; none past the edge
    if (active) {
      for (int p = slot; p < kZR * kZC; p += slots) {
        const int lr = p / kZC, lc = p - lr * kZC;
        const int ih = 2 * u0 - 1 + lr, iw = 2 * v0 - 1 + lc;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          stage<T, VEC>(zt + p * cs + lane * VEC,
                        zb + ((int64_t)ih * W + iw) * C);
      }
    }
    if constexpr (VEC > 1) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (!active) return;

  float gam[VEC], bet[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    gam[j] = vector_at(gamma, vec_bf16, c + j);
    bet[j] = vector_at(beta, vec_bf16, c + j);
  }
  T* yb = y + (int64_t)b * OH * OW * C + c;
  for (int p = slot; p < kPairs; p += slots) {
    const int pu = 2 * (p / kTV), pv = p % kTV;  // tile-local window
    const int u = u0 + pu, v = v0 + pv;
    if (u >= OH || v >= OW) continue;
    bool in[5][3];
    Raw<T, VEC> raw[5][3];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int ih = 2 * u - 1 + r;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int iw = 2 * v - 1 + s;
        in[r][s] = ih >= 0 && ih < H && iw >= 0 && iw < W;
        // unstaged, every load first: all 15 are in flight together
        if constexpr (!staged<T>()) {
          if (in[r][s]) {
            const T* src = zb + ((int64_t)ih * W + iw) * C;
            if constexpr (VEC == 1) {
              raw[r][s] = __ldg(src);
            } else {
              raw[r][s] = __ldg(reinterpret_cast<const uint4*>(src));
            }
          }
        }
      }
    }
    float row[5][VEC];  // each input row's max over the window's columns
#pragma unroll
    for (int r = 0; r < 5; ++r) {
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        float a[VEC];
        if (in[r][s]) {
          if constexpr (staged<T>()) {
            raw[r][s] = *reinterpret_cast<const Raw<T, VEC>*>(
                zt + ((2 * pu + r) * kZC + 2 * pv + s) * cs + lane * VEC);
          }
          unpack<T, VEC>(raw[r][s], a);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            a[j] = __fadd_rn(__fmul_rn(gam[j], a[j]), bet[j]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) a[j] = -CUDART_INF_F;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          row[r][j] = s == 0 ? a[j] : max_nan(row[r][j], a[j]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && u + 1 >= OH) break;
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float best = max_nan(max_nan(row[2 * k][j], row[2 * k + 1][j]),
                                   row[2 * k + 2][j]);
        out[j] = best > 0.f ? best : 0.f;
      }
      store_vec<T, VEC>(yb + ((int64_t)(u + k) * OW + v) * C, out);
    }
  }
}

dim3 block_for(const Geo& geo) { return dim3(geo.lanes, geo.slots); }

template <typename T, int VEC>
int launch(const void* z, const void* gamma, const void* beta, int vec_bf16,
           void* y, int B, int H, int W, int C, cudaStream_t stream) {
  const Geo geo = geo_for<T, VEC>(H, W, C);
  const int64_t blocks = (int64_t)B * geo.tiles_u * geo.tiles_v * geo.chunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  fused_stem_fwd_kernel<T, VEC>
      <<<(unsigned)blocks, block_for(geo), geo.bytes, stream>>>(
          static_cast<const T*>(z), gamma, beta, vec_bf16,
          static_cast<T*>(y), geo);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator say of one instantiation
// at channel count C: out = {registers a thread, local (spill) bytes a
// thread, shared bytes a block, threads a block, resident blocks an SM}.
template <typename T, int VEC>
int attrs(int C, int* out) {
  const Geo geo = geo_for<T, VEC>(2, 2, C);
  const auto kernel = fused_stem_fwd_kernel<T, VEC>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
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

// dtype: 0 = float32, 1 = bfloat16 (z and y); vec: 1 = 16-byte channel
// vectors (C a multiple of 4 for f32 or 8 for bf16, z and y 16-byte
// aligned), 0 = one channel a thread; vdtype: the dtype of gamma/beta, 0 =
// float32, 1 = bfloat16. z is [B, H, W, C] contiguous, y is [B, ceil(H/2),
// ceil(W/2), C] contiguous, gamma/beta are [C] contiguous. An empty shape
// launches nothing.
extern "C" int dptpu_fused_stem_fwd(int dtype, int vec, int vdtype,
                                    const void* z, const void* gamma,
                                    const void* beta, void* y, int B, int H,
                                    int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || (vdtype != 0 && vdtype != 1))
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned16(z) && aligned16(y) && C % (dtype == 0 ? 4 : 8) == 0))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    return launch<float, 4>(z, gamma, beta, vdtype, y, B, H, W, C, s);
  if (dtype == 0)
    return launch<float, 1>(z, gamma, beta, vdtype, y, B, H, W, C, s);
  if (vec)
    return launch<__nv_bfloat16, 8>(z, gamma, beta, vdtype, y, B, H, W, C, s);
  return launch<__nv_bfloat16, 1>(z, gamma, beta, vdtype, y, B, H, W, C, s);
}

// Registers, spills, shared memory, threads and resident blocks of the
// instantiation (dtype, vec) at channel count C, into out[5]; returns a
// cudaError_t.
extern "C" int dptpu_fused_stem_fwd_attrs(int dtype, int vec, int C,
                                          void* out) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  if (dtype == 0) return vec ? attrs<float, 4>(C, o) : attrs<float, 1>(C, o);
  if (dtype == 1)
    return vec ? attrs<__nv_bfloat16, 8>(C, o) : attrs<__nv_bfloat16, 1>(C, o);
  return (int)cudaErrorInvalidValue;
}
