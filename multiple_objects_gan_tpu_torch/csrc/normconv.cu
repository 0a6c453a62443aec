// K4: one link of the BatchNorm-fused conv chain for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tools/spike_normconv.py:normconv (body
// _normconv_kernel). For x (B, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout)
// bf16 HWIO and the folded per-channel f32 scale and shift of the previous
// BatchNorm:
//
//   xn[b, h, w, ci] = bf16(relu(x * scale[ci] + shift[ci]))       (f32 math)
//   acc[b, h, w, co] = sum_{dy, dx, ci} xn[b, h+dy-1, w+dx-1, ci] * w[dy, dx, ci, co]
//   y = bf16(acc);  sum[co] = sum acc;  sq[co] = sum acc^2        (f32)
//
// with zero padding of the NORMALIZED tensor: a tap outside the image adds
// nothing. (The Pallas wrapper pads x with -shift/scale rounded to bf16, so
// its border taps are only near zero, and relu(beta) where gamma is 0; the
// port follows the function the spike states and its XLA baseline.)
//
// Bound: operations. At the hot shape (384, 16, 16, 512 -> 256) the product
// is 2.3e11 flops, 0.23 ms at the 989 TFLOP/s bf16 rate, against 0.05 ms for
// its 153 MB of input and output. So the design is an implicit GEMM on the
// tensor cores: M = B*H*W output pixels, N = Cout, K = 9*Cin, which NHWC
// makes contiguous within a tap.
//
// Design (simple first; wgmma and TMA are later work): a block computes a
// 128 x 64 tile of (pixels x output channels) with eight warps, each 32 x 32
// as 2 x 2 nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators. For
// each 32-deep slice of K the block loads the A tile through the prologue
// (8 channels = 16 bytes a thread a load, normalized, relu'd and rounded to
// bf16 on the way into shared memory; a tap outside the image loads zeros)
// and the B tile from the flattened weights (9*Cin, Cout), then runs the
// fragments. No double buffering. The epilogue stages the f32 accumulators
// in shared memory (over the A and B tiles), writes y in bf16, and sums each
// output channel's column of the tile in a fixed order into one partial row
// per row-block. A second kernel adds the partial rows in row-block order.
// No atomics: the statistics are the same on every run. Cin and Cout must be
// multiples of 8 (one 16-byte vector); the edges of M, N and K are masked.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;             // output pixels a block
constexpr int kBN = 64;              // output channels a block
constexpr int kBK = 32;              // depth of one K slice
constexpr int kThreads = 256;        // 8 warps: 4 along M x 2 along N
constexpr int kVec = 8;              // bf16 values in one 16-byte load
constexpr int kLdA = kBK + 8;        // padded leading dims (multiples of 8)
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;        // f32, a multiple of 4
constexpr int kSmemA = kBM * kLdA * 2;
constexpr int kSmemB = kBK * kLdB * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmem = (kSmemA + kSmemB > kSmemC) ? kSmemA + kSmemB : kSmemC;
constexpr int kRowGroups = kThreads / kBN;       // 4 row groups of the stats
constexpr int kAVecs = kBM * kBK / kVec / kThreads;  // 2 A loads a thread
static_assert(kBK * kBN / kVec == kThreads, "one B load a thread");
static_assert(kBM % kRowGroups == 0, "row groups split the tile");

__global__ void __launch_bounds__(kThreads)
normconv_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const bf16* __restrict__ w,
                bf16* __restrict__ y, float* __restrict__ part_sum,
                float* __restrict__ part_sq, int batch, int height, int width,
                int cin, int cout) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  __shared__ float red_sum[kRowGroups][kBN];
  __shared__ float red_sq[kRowGroups][kBN];
  bf16* a_tile = reinterpret_cast<bf16*>(smem);
  bf16* b_tile = reinterpret_cast<bf16*>(smem + kSmemA);
  float* c_tile = reinterpret_cast<float*>(smem);

  const int m_total = batch * height * width;
  const int k_total = 9 * cin;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;

  // the pixels of this thread's A loads do not change along K
  int a_row[kAVecs], a_b[kAVecs], a_h[kAVecs], a_w[kAVecs];
#pragma unroll
  for (int i = 0; i < kAVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    a_row[i] = v / (kBK / kVec);
    const int m = m0 + a_row[i];
    const int hw = height * width;
    a_b[i] = m < m_total ? m / hw : -1;
    const int r = m - a_b[i] * hw;
    a_h[i] = r / width;
    a_w[i] = r - a_h[i] * width;
  }
  const int b_row = threadIdx.x / (kBN / kVec);
  const int b_col = (threadIdx.x % (kBN / kVec)) * kVec;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    // A: the prologue. Cin % 8 == 0, so 8 consecutive k share one tap.
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int kv = (v % (kBK / kVec)) * kVec;
      const int k = k0 + kv;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (a_b[i] >= 0 && k < k_total) {
        const int tap = k / cin;
        const int ci = k - tap * cin;
        const int dy = tap / 3;
        const int hh = a_h[i] + dy - 1;
        const int ww = a_w[i] + (tap - dy * 3) - 1;
        if (hh >= 0 && hh < height && ww >= 0 && ww < width) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              x + ((static_cast<size_t>(a_b[i]) * height + hh) * width + ww) *
                      cin + ci));
          const bf16* in = reinterpret_cast<const bf16*>(&raw);
          bf16* out = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            // x * scale, then + shift, rounded one at a time as the plain
            // version's two torch ops round them
            const float t = __fadd_rn(
                __fmul_rn(__bfloat162float(in[j]), __ldg(scale + ci + j)),
                __ldg(shift + ci + j));
            out[j] = __float2bfloat16_rn(fmaxf(t, 0.0f));
          }
        }
      }
      *reinterpret_cast<uint4*>(a_tile + a_row[i] * kLdA + kv) = packed;
    }
    // B: rows k0.. of the (9*Cin, Cout) weights
    {
      const int k = k0 + b_row;
      const int n = n0 + b_col;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (k < k_total && n < cout) {
        packed = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k) * cout + n));
      }
      *reinterpret_cast<uint4*>(b_tile + b_row * kLdB + b_col) = packed;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], a_tile + (wm * 32 + i * 16) * kLdA + kk,
                               kLdA);
        wmma::load_matrix_sync(fb[i], b_tile + kk * kLdB + wn * 32 + i * 16,
                               kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the f32 tile goes to shared memory over the A and B tiles
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(
          c_tile + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
          kLdC, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int v = threadIdx.x; v < kBM * kBN / kVec; v += kThreads) {
    const int r = v / (kBN / kVec);
    const int c = (v % (kBN / kVec)) * kVec;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= m_total || n >= cout) continue;
    uint4 packed;
    bf16* out = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out[j] = __float2bfloat16_rn(c_tile[r * kLdC + c + j]);
    }
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * cout + n) = packed;
  }

  // statistics of the f32 accumulators, in a fixed order: each thread sums
  // a quarter of a column's rows, then the four quarters are added in order
  const int col = threadIdx.x % kBN;
  const int group = threadIdx.x / kBN;
  const int rows = kBM / kRowGroups;
  float s = 0.0f;
  float q = 0.0f;
  for (int r = group * rows; r < (group + 1) * rows; ++r) {
    if (m0 + r >= m_total) break;
    const float v = c_tile[r * kLdC + col];
    s = __fadd_rn(s, v);
    q = __fadd_rn(q, __fmul_rn(v, v));
  }
  red_sum[group][col] = s;
  red_sq[group][col] = q;
  __syncthreads();
  if (group == 0 && n0 + col < cout) {
    float ts = 0.0f;
    float tq = 0.0f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) {
      ts = __fadd_rn(ts, red_sum[g][col]);
      tq = __fadd_rn(tq, red_sq[g][col]);
    }
    part_sum[static_cast<size_t>(blockIdx.x) * cout + n0 + col] = ts;
    part_sq[static_cast<size_t>(blockIdx.x) * cout + n0 + col] = tq;
  }
}

// sum and sq of every channel: the partial rows added in row-block order
__global__ void normconv_stats_kernel(const float* __restrict__ part_sum,
                                      const float* __restrict__ part_sq,
                                      float* __restrict__ sum,
                                      float* __restrict__ sq, int row_blocks,
                                      int cout) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cout) return;
  float s = 0.0f;
  float q = 0.0f;
  for (int i = 0; i < row_blocks; ++i) {
    s = __fadd_rn(s, part_sum[static_cast<size_t>(i) * cout + n]);
    q = __fadd_rn(q, part_sq[static_cast<size_t>(i) * cout + n]);
  }
  sum[n] = s;
  sq[n] = q;
}

}  // namespace

// The rows of the partial-statistics scratch the caller allocates:
// part_sum and part_sq are (normconv_row_blocks(...), Cout) f32.
extern "C" int normconv_row_blocks(int batch, int height, int width) {
  const long long m = static_cast<long long>(batch) * height * width;
  return static_cast<int>((m + kBM - 1) / kBM);
}

// x (B, H, W, Cin) bf16, scale and shift (Cin) f32, w (3, 3, Cin, Cout)
// bf16, y (B, H, W, Cout) bf16, sum and sq (Cout) f32: contiguous, 16-byte
// aligned, on the current device; Cin and Cout multiples of 8. Returns
// cudaGetLastError() after the two launches.
extern "C" int normconv_bf16(const void* x, const float* scale,
                             const float* shift, const void* w, void* y,
                             float* part_sum, float* part_sq, float* sum,
                             float* sq, int batch, int height, int width,
                             int cin, int cout, void* stream) {
  const long long m = static_cast<long long>(batch) * height * width;
  if (batch < 1 || height < 1 || width < 1 || cin < kVec || cout < kVec ||
      cin % kVec || cout % kVec || m > 0x7fffffffLL ||
      9LL * cin > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_blocks = normconv_row_blocks(batch, height, width);
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  normconv_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), scale, shift, static_cast<const bf16*>(w),
      static_cast<bf16*>(y), part_sum, part_sq, batch, height, width, cin,
      cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  normconv_stats_kernel<<<(cout + 127) / 128, 128, 0, s>>>(
      part_sum, part_sq, sum, sq, row_blocks, cout);
  return static_cast<int>(cudaGetLastError());
}
