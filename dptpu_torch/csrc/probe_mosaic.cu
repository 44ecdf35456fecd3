// The layout probes of scripts/probe_mosaic.py for Hopper (sm_90a).
//
// x is f32 [H, W, S, L], contiguous, H and W even, L a multiple of 4. The
// TPU kernels run a grid over S, one [H, W, 1, L] block per step; the
// entries here cover the whole tensor in one launch:
//
//   dptpu_probe_squeeze       o = 2 x                        (k_squeeze, :48)
//   dptpu_probe_parity_rows   o[:H/2] = x[0::2], o[H/2:] = x[1::2]
//                                                              (k_parity, :55)
//   dptpu_probe_parity_cols   the same split along W       (k_parity_col, :66)
//   dptpu_probe_interleave    o[2q] = x[q], o[2q+1] = x[H/2+q]
//                                                          (k_interleave, :77)
//   dptpu_probe_accum         o = x, acc[l] = sum over h, w, s of x[h,w,s,l]
//                                                               (k_accum, :87)
//
// Bound on this card: bytes. Each probe reads x once and writes o once
// (plus acc's L floats) with at most one multiply or add per element, so
// the least time is (read + write bytes) / 3.35 TB/s: at the scripts'
// [16,16,2,128] 256 KiB, 78 ns (a launch costs more); at [112,112,2,4096],
// the train stem's size in f32, 822.1 MB, 245.4 us.
//
// Design. The gathers are one float4 per thread along the contiguous L
// (layout_gather.cuh): the parity reshapes and stack+reshapes that Mosaic
// needed in place of stride-2 slices are index arithmetic here, and no
// shared memory is used.
//
// The squeeze (k_squeeze, scripts/probe_mosaic.py:48, o = 2 x, exact) is a
// streaming copy with a multiply: one float4 per thread, 256 threads a
// block, one block per 256 float4s, so every load has its own thread and
// the card keeps as many in flight as it can hold. Timed in turns against
// torch.mul(x, 2.0) it read 0.7% slower (277.4 against 275.4 us at the
// train stem's size, H100 80GB HBM3 at 700 W), a gap below the spread
// between calls; chip_smoke.py now times the two as a paired A/B (20 ABBA
// alternations of their windows) and prints the median paired difference
// and its spread (PERF.md has the verdict). Tried on the card in paired
// A/Bs and not kept: a persistent grid-stride loop with the grid at SMs x
// resident blocks and two independent float4 loads issued before their
// stores, with and without __ldcs/__stcs (evict-first), and with 128-thread
// blocks — all slower than this kernel, outside the spread; 128-thread
// blocks and evict-first loads and stores without the persistent grid —
// within the spread, so the simplest form stays.
//
// k_accum carries its sum in a VMEM scratch across the sequential grid over
// S. On the card blocks run in no order and float atomics would change the
// bits run to run, so each block copies its rows, sums them per lane in f64
// in a fixed order (each thread its rows in turn, then the block's threads
// in order) into a caller-allocated [chunks, L] f64 buffer, and a second
// kernel sums the chunks per lane in order and rounds once to f32. The
// result is the same on every launch and within 2^-24 of the exact sum.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise; each entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout_gather.cuh"

namespace {

using dptpu_probe::float4_count;
using dptpu_probe::kThreads;

__global__ void scale2_kernel(const float4* __restrict__ src,
                              float4* __restrict__ dst, uint32_t total) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float4 v = __ldg(src + i);
  dst[i] = make_float4(__fmul_rn(v.x, 2.f), __fmul_rn(v.y, 2.f),
                       __fmul_rn(v.z, 2.f), __fmul_rn(v.w, 2.f));
}

// the accumulator: a block is kAccX float4 lanes wide and kAccY rows tall
constexpr unsigned kAccX = 32, kAccY = 8;
// enough blocks to fill the card's 132 SMs several times over
constexpr int64_t kAccBlocks = 1024;

struct AccumGrid {
  uint32_t lane_tiles, chunks, rows_per_chunk;
};

AccumGrid accum_grid(int64_t rows, int64_t lanes4) {
  AccumGrid g;
  g.lane_tiles = (uint32_t)((lanes4 + kAccX - 1) / kAccX);
  int64_t chunks = (kAccBlocks + g.lane_tiles - 1) / g.lane_tiles;
  const int64_t most = (rows + kAccY - 1) / kAccY;  // >= kAccY rows a block
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;  // gridDim.y
  g.rows_per_chunk = (uint32_t)((rows + chunks - 1) / chunks);
  g.chunks = (uint32_t)((rows + g.rows_per_chunk - 1) / g.rows_per_chunk);
  return g;
}

// x and o viewed as [rows, lanes4] float4s; partials is [chunks, 4*lanes4]
__global__ void accum_copy_kernel(const float4* __restrict__ src,
                                  float4* __restrict__ dst,
                                  double* __restrict__ partials, uint32_t rows,
                                  uint32_t lanes4, uint32_t rows_per_chunk) {
  __shared__ double part[kAccY][kAccX][4];
  const uint32_t c = blockIdx.x * kAccX + threadIdx.x;
  const uint32_t r0 = blockIdx.y * rows_per_chunk;
  const uint32_t r1 = min(r0 + rows_per_chunk, rows);
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  if (c < lanes4) {
    for (uint32_t r = r0 + threadIdx.y; r < r1; r += kAccY) {
      const int64_t k = (int64_t)r * lanes4 + c;
      const float4 v = __ldg(src + k);
      dst[k] = v;
      s0 += v.x;
      s1 += v.y;
      s2 += v.z;
      s3 += v.w;
    }
  }
  part[threadIdx.y][threadIdx.x][0] = s0;
  part[threadIdx.y][threadIdx.x][1] = s1;
  part[threadIdx.y][threadIdx.x][2] = s2;
  part[threadIdx.y][threadIdx.x][3] = s3;
  __syncthreads();
  if (threadIdx.y != 0 || c >= lanes4) return;
  double* out = partials + (int64_t)blockIdx.y * 4 * lanes4 + 4 * (int64_t)c;
  for (int k = 0; k < 4; ++k) {
    double s = 0.0;
    for (unsigned y = 0; y < kAccY; ++y) s += part[y][threadIdx.x][k];
    out[k] = s;
  }
}

__global__ void accum_finalize_kernel(const double* __restrict__ partials,
                                      float* __restrict__ acc, uint32_t chunks,
                                      uint32_t lanes) {
  const uint32_t l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  double s = 0.0;
  for (uint32_t k = 0; k < chunks; ++k) s += partials[(int64_t)k * lanes + l];
  acc[l] = __double2float_rn(s);
}

template <class Map>
int gather(const void* x, void* o, int H, int W, int S, int L, bool rows,
           void* stream) {
  const int64_t total = float4_count(H, W, S, L);
  const int64_t run = (int64_t)S * (L / 4);  // float4s under one (h, w)
  return dptpu_probe::launch_gather_rows<Map>(
      x, o, total, rows ? H : W, rows ? W * run : run,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int dptpu_probe_squeeze(const void* x, void* o, int H, int W,
                                   int S, int L, void* stream) {
  const int64_t total = float4_count(H, W, S, L);
  if (total < 0) return (int)cudaErrorInvalidValue;
  scale2_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o),
      (uint32_t)total);
  return (int)cudaGetLastError();
}

extern "C" int dptpu_probe_parity_rows(const void* x, void* o, int H, int W,
                                       int S, int L, void* stream) {
  return gather<dptpu_probe::ParitySplit>(x, o, H, W, S, L, true, stream);
}

extern "C" int dptpu_probe_parity_cols(const void* x, void* o, int H, int W,
                                       int S, int L, void* stream) {
  return gather<dptpu_probe::ParitySplit>(x, o, H, W, S, L, false, stream);
}

extern "C" int dptpu_probe_interleave(const void* x, void* o, int H, int W,
                                      int S, int L, void* stream) {
  return gather<dptpu_probe::Interleave>(x, o, H, W, S, L, true, stream);
}

// The f64 partial-sum rows dptpu_probe_accum needs: its partials buffer is
// [dptpu_probe_accum_chunks(...), L] doubles.
extern "C" int dptpu_probe_accum_chunks(int H, int W, int S, int L) {
  if (float4_count(H, W, S, L) < 0) return 0;
  return (int)accum_grid((int64_t)H * W * S, L / 4).chunks;
}

extern "C" int dptpu_probe_accum(const void* x, void* o, void* partials,
                                 void* acc, int H, int W, int S, int L,
                                 void* stream) {
  if (float4_count(H, W, S, L) < 0) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)H * W * S;
  const AccumGrid g = accum_grid(rows, L / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  accum_copy_kernel<<<dim3(g.lane_tiles, g.chunks), dim3(kAccX, kAccY), 0,
                      s>>>(static_cast<const float4*>(x),
                           static_cast<float4*>(o),
                           static_cast<double*>(partials), (uint32_t)rows,
                           (uint32_t)(L / 4), g.rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  accum_finalize_kernel<<<(unsigned)((L + kThreads - 1) / kThreads), kThreads,
                          0, s>>>(static_cast<const double*>(partials),
                                  static_cast<float*>(acc), g.chunks,
                                  (uint32_t)L);
  return (int)cudaGetLastError();
}
