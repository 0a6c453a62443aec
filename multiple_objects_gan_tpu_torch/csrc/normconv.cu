// K4: one link of the BatchNorm-fused conv chain for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tools/spike_normconv.py:normconv (body
// _normconv_kernel). For x (B, H, W, Cin) bf16 NHWC, the weights bf16 and
// the folded per-channel f32 scale and shift of the previous BatchNorm:
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
// Bound: operations. At the hot shape (384, 16, 16, 512 -> 256) the in-image
// taps are 2.1e11 flops, 0.215 ms at the 989 TFLOP/s bf16 rate, against
// 0.05 ms for its 153 MB of input and output. Only wgmma reaches that rate,
// so K4 is an implicit GEMM on it: M = B*H*W output pixels, N = Cout,
// K = 9 taps x Cin, which NHWC makes contiguous within a tap.
//
// Design. A block computes a 128 x BN tile of (pixels x output channels),
// BN = 256 when Cout > 128 and 128 otherwise, so at Cout 256 each x tile is
// read, normalized and rounded once. Its 384 threads are three
// warpgroups, specialized: two consumers, each the owner of 64 rows, issue
// wgmma.m64nBNk16 with both operands in shared memory and f32 accumulators
// in registers (BN / 2 a thread); one producer loads and normalizes. K runs
// in slices of one tap x 64 channels (one 128-byte swizzle row of bf16)
// through a ring of kStages shared-memory stages, each with a full and an
// empty mbarrier:
//  - B, the weights, repacked by the wrapper to (Cout, 3, 3, Cin): one 3-D
//    TMA box (64 channels, 1 tap, BN outputs) a slice, 128-byte swizzle,
//    completing on the stage's full barrier. Channels past Cin and outputs
//    past Cout are the box's out-of-bounds zero fill. The tensor map is
//    built on the host for each call by cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint (no -lcuda), and passed as a
//    __grid_constant__ parameter.
//  - A, the nine shifted windows of x: a tap is the constant shift
//    (dy - 1) W + (dx - 1) of the flat NHWC pixel index, so the tile's
//    taps reach only its halo, the pixels m0 - (W + 1) .. m0 + 127 + W + 1.
//    For each 64-channel slice the producer loads the halo once (16-byte
//    loads into registers, zero past the ends and past Cin), normalizes it
//    once into shared memory (x * scale, then + shift, rounded one at a
//    time as the plain version's two torch ops round them; relu; bf16),
//    and then fills nine stages, one a tap, by gathering the tile's rows
//    from the halo into the swizzled layout, with zeros where the tap falls
//    outside the image: the mask comes from (h, w, tap), not from the
//    value, since a raw zero normalizes to relu(shift). Each x value is
//    read from memory and normalized once a slice, not once a tap (9x less
//    of the producer's arithmetic and of A's traffic). The next slice's
//    halo loads fly while this one's taps are gathered. scale and shift
//    for the whole Cin sit in shared memory, read as float4s. A
//    fence.proxy.async and an arrive on the full barrier hand a stage to
//    wgmma.
// So loads, the normalize, the gathers and the products overlap; a
// consumer releases a stage (empty barrier) once the wgmma group that read
// it has retired. 384 threads a block, one block an SM, leave 168
// registers a thread, enough for a consumer's 128 accumulators without
// moving registers between warpgroups (setmaxnreg).
// Epilogue, in the consumers: y goes out as bf16 through shared memory
// with 16-byte coalesced stores. Each thread adds its two rows of the f32
// accumulators per column, lanes combine by a fixed butterfly of shuffles,
// the 8 warps' rows in warp order into one partial row per row-block; a
// second kernel adds the partial rows in a fixed order (16 strided lanes,
// then the lanes in turn). No atomics: the statistics are the same on
// every run. Edges: Cin and Cout must be multiples of 8 (one 16-byte
// vector), Cin at most kMaxCin and W at most kMaxWidth (the wrapper
// refuses others); a Cin that is not a multiple of 64 takes a masked tail
// slice (zero-filled A chunks and B channels), and the edges of M and N
// are masked. The kernels allocate nothing and launch on the caller's
// stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;             // output pixels a block
constexpr int kBK = 64;              // channels of one K slice (128 bytes)
constexpr int kStages = 4;           // shared-memory ring
constexpr int kMaxWidth = 32;        // the halo buffer fits beside it
constexpr int kProducers = 128;      // one warpgroup: A loads, normalize
constexpr int kConsumers = 256;      // two warpgroups: wgmma, 64 rows each
constexpr int kThreads = kProducers + kConsumers;
constexpr int kVec = 8;              // bf16 values in one 16-byte chunk
constexpr int kMaxCin = 1024;        // scale and shift held in shared memory
constexpr int kATile = kBM * kBK * 2;          // 16 KB a stage
constexpr int kRowsPerThread = kBM * kBK / kVec / kProducers;  // 8
constexpr int kRowStep = kProducers / 8;       // rows between a thread's rows
static_assert(kRowStep % 8 == 0, "a thread's rows share their swizzle");

// the halo of a tile: its 128 rows and W + 1 pixels on either side, in
// whole 8-row groups
__host__ __device__ constexpr int halo_rows_of(int width) {
  return (kBM + 2 * (width + 1) + 7) / 8 * 8;
}
// a producer thread's halo rows, at most
constexpr int kHaloPerThread =
    (halo_rows_of(kMaxWidth) + kRowStep - 1) / kRowStep;

template <int BN>
constexpr int smem_bytes(int cin_pad, int width) {
  return 1024 + kStages * (kATile + BN * kBK * 2) +
         halo_rows_of(width) * 128 + 2 * cin_pad * 4 + 2 * kStages * 8;
}
static_assert(smem_bytes<256>(kMaxCin, kMaxWidth) <= 232448,
              "the largest tile fits the 227 KB a block can have");

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
normconv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                      const bf16* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, bf16* __restrict__ y,
                      float* __restrict__ part_sum,
                      float* __restrict__ part_sq, int batch, int height,
                      int width, int cin, int cout) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int chunks = (cin + kBK - 1) / kBK;
  const int cin_pad = chunks * kBK;
  const int nk = 9 * chunks;
  const int halo_rows = halo_rows_of(width);
  const int halo_bytes = halo_rows * 128;
  unsigned char* a_st = smem;
  unsigned char* b_st = smem + kStages * kATile;
  unsigned char* halo = b_st + kStages * BN * kBK * 2;
  float* s_scale = reinterpret_cast<float*>(halo + halo_bytes);
  float* s_shift = s_scale + cin_pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_shift + cin_pad);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int hw = height * width;
  const int m_total = batch * hw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  for (int i = tid * 4; i < cin_pad; i += kThreads * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 t = s;
    if (i < cin) {                    // cin % 8 == 0: all four are inside
      s = __ldg(reinterpret_cast<const float4*>(scale + i));
      t = __ldg(reinterpret_cast<const float4*>(shift + i));
    }
    *reinterpret_cast<float4*>(s_scale + i) = s;
    *reinterpret_cast<float4*>(s_shift + i) = t;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: every producer thread's gather, and the B tile's bytes
      hopper::mbar_init(&full[s], kProducers + 1);
      // empty: both consumer warpgroups done reading the stage
      hopper::mbar_init(&empty[s], kConsumers / 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid < kProducers) {
    // ------------------------------------------------- producer warpgroup
    // A thread owns chunk column c (8 channels) of the tile's rows
    // row0 + 16 i; the 128-byte swizzle puts chunk c of row r at chunk
    // c ^ (r % 8), the same for all of a thread's rows.
    const int c = tid & 7;
    const int row0 = tid >> 3;
    const int sw_off = ((c ^ (row0 & 7)) << 4);
    int a_h[kRowsPerThread], a_w[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = m0 + row0 + kRowStep * i;
      if (m < m_total) {
        const int r = m - (m / hw) * hw;
        a_h[i] = r / width;
        a_w[i] = r - a_h[i] * width;
      } else {                        // past M: every tap reads nothing
        a_h[i] = -4;
        a_w[i] = -4;
      }
    }
    // the halo: pixels m0 - (W + 1) .. m0 + 127 + (W + 1) in NHWC order,
    // every source pixel a tap of the tile can reach (a tap is the
    // constant shift (dy - 1) W + (dx - 1) of the flat pixel index)
    const int halo0 = m0 - (width + 1);

    // the halo's chunks of channel slice cc, this thread's rows, fetched
    // into registers: the loads of slice cc + 1 fly while slice cc's taps
    // are gathered
    uint4 raw[kHaloPerThread];
    auto fetch_halo = [&](int cc) {
      const int ci = cc * kBK + c * kVec;
#pragma unroll
      for (int j = 0; j < kHaloPerThread; ++j) {
        const int r = row0 + kRowStep * j;
        const int pix = halo0 + r;
        raw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (r < halo_rows && pix >= 0 && pix < m_total && ci < cin) {
          raw[j] = __ldg(reinterpret_cast<const uint4*>(
              x + static_cast<size_t>(pix) * cin + ci));
        }
      }
    };

    fetch_halo(0);
#pragma unroll 1
    for (int cc = 0; cc < chunks; ++cc) {
      // normalize the fetched chunks into the halo: x * scale, then
      // + shift, rounded one at a time as the plain version's two torch
      // ops round them; relu; bf16
      {
        const int ci = cc * kBK + c * kVec;
        const float4 sc0 = *reinterpret_cast<const float4*>(s_scale + ci);
        const float4 sc1 = *reinterpret_cast<const float4*>(s_scale + ci + 4);
        const float4 sh0 = *reinterpret_cast<const float4*>(s_shift + ci);
        const float4 sh1 = *reinterpret_cast<const float4*>(s_shift + ci + 4);
        const float sc[kVec] = {sc0.x, sc0.y, sc0.z, sc0.w,
                                sc1.x, sc1.y, sc1.z, sc1.w};
        const float sh[kVec] = {sh0.x, sh0.y, sh0.z, sh0.w,
                                sh1.x, sh1.y, sh1.z, sh1.w};
#pragma unroll
        for (int j = 0; j < kHaloPerThread; ++j) {
          const int r = row0 + kRowStep * j;
          if (r >= halo_rows) break;
          const bf16* in = reinterpret_cast<const bf16*>(&raw[j]);
          uint4 packed;
          bf16* out = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float t =
                __fadd_rn(__fmul_rn(__bfloat162float(in[e]), sc[e]), sh[e]);
            out[e] = __float2bfloat16_rn(fmaxf(t, 0.0f));
          }
          *reinterpret_cast<uint4*>(halo + r * 128 + c * 16) = packed;
        }
      }
      hopper::named_sync(2, kProducers);    // the whole halo is normalized
      if (cc + 1 < chunks) fetch_halo(cc + 1);

      // the nine taps of slice cc: each stage gathers the tile's rows from
      // the halo, with zeros where the tap falls outside the image (the
      // mask comes from (h, w, tap), not from the value: a raw zero
      // normalizes to relu(shift))
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int k = cc * 9 + tap;
        const int s = k % kStages;
        if (k >= kStages) hopper::mbar_wait(&empty[s], (k / kStages - 1) & 1);
        const int dy = tap / 3;
        const int dx = tap - dy * 3;
        if (tid == 0) {
          hopper::mbar_expect_tx(&full[s], BN * kBK * 2);
          hopper::tma_load_3d(b_st + s * BN * kBK * 2, &wmap, &full[s],
                              cc * kBK, tap, n0);
        }
        const unsigned char* h = halo + c * 16 +
                                 ((dy - 1) * width + dx + width) * 128;
        unsigned char* a = a_st + s * kATile;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = row0 + kRowStep * i;
          const int hh = a_h[i] + dy - 1;
          const int ww = a_w[i] + dx - 1;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (static_cast<unsigned>(hh) < static_cast<unsigned>(height) &&
              static_cast<unsigned>(ww) < static_cast<unsigned>(width)) {
            v = *reinterpret_cast<const uint4*>(h + row * 128);
          }
          *reinterpret_cast<uint4*>(a + row * 128 + sw_off) = v;
        }
        hopper::fence_proxy_async();  // the gathered stage, to wgmma
        hopper::mbar_arrive(&full[s]);
      }
      // every producer thread is done with the halo before slice cc + 1
      // is normalized into it
      hopper::named_sync(2, kProducers);
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  const int ct = tid - kProducers;    // 0 .. kConsumers - 1
  const int wg = ct / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll 1
  for (int k = 0; k < nk; ++k) {
    const int s = k % kStages;
    hopper::mbar_wait(&full[s], (k / kStages) & 1);
    hopper::wgmma_fence();
    const uint64_t da = hopper::sw128_desc(a_st + s * kATile + wg * 64 * 128);
    const uint64_t db = hopper::sw128_desc(b_st + s * BN * kBK * 2);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (BN == 256) {
        hopper::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
      } else {
        hopper::wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();          // slice k - 1 retired: release it
    if (k > 0 && ct % 128 == 0) hopper::mbar_arrive(&empty[(k - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  // every consumer's products are done before the ring is reused (the
  // producers wrote their last stage before its full barrier completed)
  hopper::named_sync(1, kConsumers);

  // epilogue: the fragment of m64nBN puts acc[4i + 2h + e] at row
  // (warp % 4) * 16 + lane / 4 + 8h of the warpgroup, column
  // 8i + 2(lane % 4) + e
  constexpr int kLdY = BN + 8;        // bf16, rows 16-byte aligned
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + kBM * kLdY * 2);  // [2][8][BN]
  const int warp = ct / 32;
  const int lane = ct % 32;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    const float v00 = acc[4 * i], v01 = acc[4 * i + 1];
    const float v10 = acc[4 * i + 2], v11 = acc[4 * i + 3];
    *reinterpret_cast<__nv_bfloat162*>(ys + r0 * kLdY + col) =
        __floats2bfloat162_rn(v00, v01);
    *reinterpret_cast<__nv_bfloat162*>(ys + (r0 + 8) * kLdY + col) =
        __floats2bfloat162_rn(v10, v11);
    float s0 = __fadd_rn(v00, v10);
    float s1 = __fadd_rn(v01, v11);
    float q0 = __fadd_rn(__fmul_rn(v00, v00), __fmul_rn(v10, v10));
    float q1 = __fadd_rn(__fmul_rn(v01, v01), __fmul_rn(v11, v11));
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, off));
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
      q0 = __fadd_rn(q0, __shfl_xor_sync(0xffffffffu, q0, off));
      q1 = __fadd_rn(q1, __shfl_xor_sync(0xffffffffu, q1, off));
    }
    if (lane < 4) {
      red[warp * BN + col] = s0;
      red[warp * BN + col + 1] = s1;
      red[(8 + warp) * BN + col] = q0;
      red[(8 + warp) * BN + col + 1] = q1;
    }
  }
  hopper::named_sync(1, kConsumers);

  for (int v = ct; v < kBM * (BN / kVec); v += kConsumers) {
    const int r = v / (BN / kVec);
    const int cc = (v - r * (BN / kVec)) * kVec;
    const int m = m0 + r;
    const int n = n0 + cc;
    if (m < m_total && n < cout) {
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * cout + n) =
          *reinterpret_cast<const uint4*>(ys + r * kLdY + cc);
    }
  }
  for (int col = ct; col < BN; col += kConsumers) {
    if (n0 + col >= cout) continue;
    float ts = 0.0f;
    float tq = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      ts = __fadd_rn(ts, red[w * BN + col]);
      tq = __fadd_rn(tq, red[(8 + w) * BN + col]);
    }
    part_sum[static_cast<size_t>(blockIdx.x) * cout + n0 + col] = ts;
    part_sq[static_cast<size_t>(blockIdx.x) * cout + n0 + col] = tq;
  }
}

// sum and sq of every channel from the partial rows, in a fixed order: a
// block takes 32 channels; its 16 row lanes each add every 16th partial
// row in row-block order, then lane 0 adds the 16 lane sums in order
constexpr int kStatCols = 32;
constexpr int kStatLanes = 16;
__global__ void __launch_bounds__(kStatCols * kStatLanes)
normconv_stats_kernel(const float* __restrict__ part_sum,
                      const float* __restrict__ part_sq,
                      float* __restrict__ sum, float* __restrict__ sq,
                      int row_blocks, int cout) {
  __shared__ float red[2][kStatLanes][kStatCols];
  const int n = blockIdx.x * kStatCols + threadIdx.x;
  float s = 0.0f;
  float q = 0.0f;
  if (n < cout) {
#pragma unroll 4
    for (int i = threadIdx.y; i < row_blocks; i += kStatLanes) {
      s = __fadd_rn(s, part_sum[static_cast<size_t>(i) * cout + n]);
      q = __fadd_rn(q, part_sq[static_cast<size_t>(i) * cout + n]);
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && n < cout) {
    float ts = 0.0f;
    float tq = 0.0f;
#pragma unroll
    for (int l = 0; l < kStatLanes; ++l) {
      ts = __fadd_rn(ts, red[0][l][threadIdx.x]);
      tq = __fadd_rn(tq, red[1][l][threadIdx.x]);
    }
    sum[n] = ts;
    sq[n] = tq;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

template <int BN>
int launch(const void* x, const float* scale, const float* shift,
           const void* w, void* y, float* part_sum, float* part_sq, int batch,
           int height, int width, int cin, int cout, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // w is (Cout, 3, 3, Cin): dims innermost first, strides in bytes
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cin), 9,
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cin) * 2,
                                 static_cast<cuuint64_t>(cin) * 18};
  const cuuint32_t box[3] = {kBK, 1, BN};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cin_pad = (cin + kBK - 1) / kBK * kBK;
  const int smem = smem_bytes<BN>(cin_pad, width);
  cudaError_t err = cudaFuncSetAttribute(
      normconv_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m = static_cast<long long>(batch) * height * width;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + BN - 1) / BN));
  normconv_wgmma_kernel<BN><<<grid, kThreads, smem, stream>>>(
      map, static_cast<const bf16*>(x), scale, shift, static_cast<bf16*>(y),
      part_sum, part_sq, batch, height, width, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows of the partial-statistics scratch the caller allocates:
// part_sum and part_sq are (normconv_row_blocks(...), Cout) f32.
extern "C" int normconv_row_blocks(int batch, int height, int width) {
  const long long m = static_cast<long long>(batch) * height * width;
  return static_cast<int>((m + kBM - 1) / kBM);
}

// x (B, H, W, Cin) bf16, scale and shift (Cin) f32, w (Cout, 3, 3, Cin)
// bf16 (the wrapper's repack of the HWIO weights), y (B, H, W, Cout) bf16,
// sum and sq (Cout) f32: contiguous, 16-byte aligned, on the current
// device; Cin and Cout multiples of 8, Cin at most kMaxCin, W at most
// kMaxWidth. Returns the first CUDA error of the two launches, or 0.
extern "C" int normconv_bf16(const void* x, const float* scale,
                             const float* shift, const void* w, void* y,
                             float* part_sum, float* part_sq, float* sum,
                             float* sq, int batch, int height, int width,
                             int cin, int cout, void* stream) {
  const long long m = static_cast<long long>(batch) * height * width;
  if (batch < 1 || height < 1 || width < 1 || cin < kVec || cout < kVec ||
      cin % kVec || cout % kVec || cin > kMaxCin || width > kMaxWidth ||
      m > 0x7fffffffLL ||
      (m + kBM - 1) / kBM > 0x7fffffffLL || (cout + 127) / 128 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      cout > 128
          ? launch<256>(x, scale, shift, w, y, part_sum, part_sq, batch,
                        height, width, cin, cout, s)
          : launch<128>(x, scale, shift, w, y, part_sum, part_sq, batch,
                        height, width, cin, cout, s);
  if (err != 0) return err;
  const int row_blocks = normconv_row_blocks(batch, height, width);
  normconv_stats_kernel<<<(cout + kStatCols - 1) / kStatCols,
                          dim3(kStatCols, kStatLanes), 0, s>>>(
      part_sum, part_sq, sum, sq, row_blocks, cout);
  return static_cast<int>(cudaGetLastError());
}
