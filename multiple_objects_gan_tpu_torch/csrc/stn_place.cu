// STN place-and-accumulate (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// multiple_objects_gan_tpu/ops/stn_pallas.py:stn_place_multi_pallas
// (body _place_kernel, weights _axis_weights_in_kernel). It computes what
// that kernel computes, not its blocks: for every batch element b and
// channel c,
//
//   out[b, c, i, j] = sum_o sum_{p,q} Wy_o[i, p] * feat[b, o, c, p, q] * Wx_o[j, q]
//
// with hat weights W[i, p] = max(0, 1 - |src_i - p|) of the place (inverse)
// affine of the object's box, align_corners=True, zero outside the input.
// A row of a hat matrix has at most two non-zeros, so each output value is a
// sum over objects of a 2x2-tap bilinear gather. The TPU kernel ran the
// resample as two small matrix products per object; here no product is
// needed.
//
// Bound: bytes. Each input value is read at most once from device memory
// and each output written once; a few operations per byte moved, far below
// the card's balance point. At the generator's shape (64,3,256,16,16) ->
// (64,256,16,16) f32 that is at most 50.3 MB read + 16.8 MB written.
//
// Design (simple first): layout NCHW, the layout the model holds, so the
// model pays no permute. One block per (b, c) output plane; threads over
// the plane's pixels, j fastest, so the stores coalesce and the taps of
// neighbouring threads fall in the same 1 KB input plane (L1 hits). The
// per-object affines are computed once per block into shared memory. Taps
// outside the input and objects whose box misses a pixel are skipped, so
// a padded object (bbox = -1) reads nothing and adds nothing. The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxObjects = 16;  // ops/stn_place_cuda.py:MAX_OBJECTS
constexpr int kThreads = 256;

// The coordinate arithmetic uses the _rn intrinsics, which the compiler
// never contracts into fused multiply-adds: it then rounds operation by
// operation as the plain version (ops/stn.py:_axis_weights) does.

// linspace(-1, 1, n)[i], written as stn_pallas.py:37
__device__ __forceinline__ float grid_coord(int i, int n) {
  if (n < 2) return -1.0f;
  return __fadd_rn(-1.0f, __fmul_rn(static_cast<float>(i),
                                    2.0f / static_cast<float>(n - 1)));
}

// src = (scale * g + trans + 1) * 0.5 * (in - 1), as stn_pallas.py:38
__device__ __forceinline__ float source_coord(float scale, float trans, float g,
                                              int in_size) {
  const float t = __fadd_rn(__fadd_rn(__fmul_rn(scale, g), trans), 1.0f);
  return __fmul_rn(__fmul_rn(t, 0.5f), static_cast<float>(in_size - 1));
}

__global__ void __launch_bounds__(kThreads)
stn_place_multi_kernel(const float* __restrict__ feat,
                       const float* __restrict__ bbox,
                       float* __restrict__ out,
                       int n_objects, int channels, int in_h, int in_w,
                       int out_h, int out_w) {
  // sx, tx, sy, ty of each object's place affine
  __shared__ float affine[kMaxObjects][4];
  const int plane = blockIdx.x;                 // b * channels + c
  const int b = plane / channels;
  const int c = plane - b * channels;
  if (threadIdx.x < n_objects) {
    const float* bb = bbox + (static_cast<size_t>(b) * n_objects + threadIdx.x) * 4;
    const float x = bb[0], y = bb[1], w = bb[2], h = bb[3];
    const float sx = 1.0f / w;
    const float sy = 1.0f / h;
    // 2 * s * (0.5 - (x + 0.5 * w)), as ops/stn.py:transformation_matrix_inverse
    affine[threadIdx.x][0] = sx;
    affine[threadIdx.x][1] = __fmul_rn(__fmul_rn(2.0f, sx),
                                       __fsub_rn(0.5f, __fadd_rn(x, __fmul_rn(0.5f, w))));
    affine[threadIdx.x][2] = sy;
    affine[threadIdx.x][3] = __fmul_rn(__fmul_rn(2.0f, sy),
                                       __fsub_rn(0.5f, __fadd_rn(y, __fmul_rn(0.5f, h))));
  }
  __syncthreads();

  const size_t in_plane = static_cast<size_t>(in_h) * in_w;
  const size_t object_stride = static_cast<size_t>(channels) * in_plane;
  const float* fb = feat + static_cast<size_t>(b) * n_objects * object_stride +
                    static_cast<size_t>(c) * in_plane;
  float* ob = out + static_cast<size_t>(plane) * out_h * out_w;
  const float fh = static_cast<float>(in_h);
  const float fw = static_cast<float>(in_w);

  for (int p = threadIdx.x; p < out_h * out_w; p += blockDim.x) {
    const int i = p / out_w;
    const int j = p - i * out_w;
    const float gy = grid_coord(i, out_h);
    const float gx = grid_coord(j, out_w);
    float acc = 0.0f;
    for (int o = 0; o < n_objects; ++o) {
      const float sy = source_coord(affine[o][2], affine[o][3], gy, in_h);
      const float sx = source_coord(affine[o][0], affine[o][1], gx, in_w);
      // every hat weight is zero outside (-1, in); NaN fails too
      if (!(sy > -1.0f && sy < fh && sx > -1.0f && sx < fw)) continue;
      const float y0f = floorf(sy);
      const float x0f = floorf(sx);
      const int y0 = static_cast<int>(y0f);
      const int x0 = static_cast<int>(x0f);
      const float ty = sy - y0f;
      const float tx = sx - x0f;
      const float wy[2] = {1.0f - ty, ty};
      const float wx[2] = {1.0f - tx, tx};
      const float* fo = fb + static_cast<size_t>(o) * object_stride;
      float v = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= in_h) continue;
        float row = 0.0f;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= in_w) continue;
          row += wx[dx] * __ldg(fo + static_cast<size_t>(yy) * in_w + xx);
        }
        v += wy[dy] * row;
      }
      acc += v;
    }
    ob[p] = acc;
  }
}

}  // namespace

// feat (B, O, C, H, W), bbox (B, O, 4), out (B, C, Ho, Wo): f32, contiguous,
// on the current device. Returns cudaGetLastError() after the launch.
extern "C" int stn_place_multi_f32(const float* feat, const float* bbox,
                                   float* out, int batch, int n_objects,
                                   int channels, int in_h, int in_w, int out_h,
                                   int out_w, void* stream) {
  if (n_objects < 1 || n_objects > kMaxObjects) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long planes = static_cast<long long>(batch) * channels;
  if (planes < 1 || planes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stn_place_multi_kernel<<<static_cast<unsigned>(planes), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      feat, bbox, out, n_objects, channels, in_h, in_w, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
