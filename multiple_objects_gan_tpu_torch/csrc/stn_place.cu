// STN place-and-accumulate (K1) and its backward (K2) for Hopper, sm_90a.
//
// K1 replaces the Pallas TPU kernel
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
// K2 replaces stn_pallas.py:stn_place_multi_grad_pallas (body
// _place_grad_kernel): the backward of K1 with the forward's own weights,
//
//   dfeat[b, o, c, p, q] = sum_{i,j} Wy_o[i, p] * grad[b, c, i, j] * Wx_o[j, q]
//
// written as a gather: each input pixel p sums over the outputs i whose
// source coordinate lies within 1 of it. The source is monotone in i, so
// those outputs form one range; the kernel finds it by testing the weights
// themselves, so it holds for any box, however wide (a box wider than the
// canvas sends several outputs to one input pixel). Each weight is
// recomputed from the same grid_coord/source_coord as K1's, so forward and
// backward use the same coordinates bit for bit. A gather writes each value
// once with a fixed order of sums, so the result does not vary from run to
// run, as a scatter with atomics would.
//
// Bound: bytes for both. Each input value is read at most once from device
// memory and each output written once; a few operations per byte moved, far
// below the card's balance point. At the generator's shape (64,3,256,16,16)
// -> (64,256,16,16) f32, K1 reads at most 50.3 MB and writes 16.8 MB; K2 at
// batch 128 reads 33.6 MB and writes 100.7 MB. In bf16 both move half that.
//
// Design (simple first): layout NCHW, the layout the model holds, so the
// model pays no permute. K1: one block per (b, c) output plane; threads over
// the plane's pixels, j fastest, so the stores coalesce and the taps of
// neighbouring threads fall in the same 1 KB input plane (L1 hits). The
// per-object affines are computed once per block into shared memory. Taps
// outside the input and objects whose box misses a pixel are skipped, so
// a padded object (bbox = -1) reads nothing and adds nothing. K2: one block
// per (b, group of kGradChannels channels); the block computes each object's
// source coordinates and tap ranges once into shared memory, then threads
// run over (channel, object, p, q), q fastest, so the stores coalesce.
// A padded object's ranges are empty, so it writes exact zeros. A box with a
// non-finite value gives non-finite sources, which K1 skips (the test below
// is false for NaN and for infinities) and K2 weighs 0 (fmaxf(0, NaN) is
// 0): both skip the object, where the plain version gives NaN. The serving
// path rejects such boxes, and training data has none. The kernels allocate
// nothing and launch on the caller's stream.
//
// Both kernels are templates on the element type of the features and the
// gradient: float32, or bf16 for the bf16 train step and serving. In bf16
// each hat weight is rounded to bf16, as the JAX package's bf16 resample
// rounds its weight matrices (multiple_objects_gan_tpu/ops/stn.py:130-138);
// the values are read as f32, the products and the sums over taps and
// objects run in f32, and the result is rounded to bf16 once on the store.
// The boxes and the coordinates stay f32 in either type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxObjects = 16;  // ops/stn_place_cuda.py:MAX_OBJECTS
constexpr int kThreads = 256;
constexpr int kMaxSide = 64;        // ops/stn_place_cuda.py:MAX_GRAD_SIDE
constexpr int kGradChannels = 4;    // channels per K2 block

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

// sx, tx, sy, ty of the place affine of one box (x, y, w, h), as
// ops/stn.py:transformation_matrix_inverse: s = 1 / w and
// t = 2 * s * (0.5 - (x + 0.5 * w)).
__device__ __forceinline__ void place_affine(const float* bb, float* affine) {
  const float x = bb[0], y = bb[1], w = bb[2], h = bb[3];
  const float sx = 1.0f / w;
  const float sy = 1.0f / h;
  affine[0] = sx;
  affine[1] = __fmul_rn(__fmul_rn(2.0f, sx),
                        __fsub_rn(0.5f, __fadd_rn(x, __fmul_rn(0.5f, w))));
  affine[2] = sy;
  affine[3] = __fmul_rn(__fmul_rn(2.0f, sy),
                        __fsub_rn(0.5f, __fadd_rn(y, __fmul_rn(0.5f, h))));
}

// a value of the element type, read as f32
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a hat weight as the element type holds it: unchanged in f32, rounded to
// bf16 in bf16
template <typename T>
__device__ __forceinline__ float weight(float w) {
  return w;
}
template <>
__device__ __forceinline__ float weight<bf16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stn_place_multi_kernel(const T* __restrict__ feat,
                       const float* __restrict__ bbox,
                       T* __restrict__ out,
                       int n_objects, int channels, int in_h, int in_w,
                       int out_h, int out_w) {
  // sx, tx, sy, ty of each object's place affine
  __shared__ float affine[kMaxObjects][4];
  const int plane = blockIdx.x;                 // b * channels + c
  const int b = plane / channels;
  const int c = plane - b * channels;
  if (threadIdx.x < n_objects) {
    place_affine(bbox + (static_cast<size_t>(b) * n_objects + threadIdx.x) * 4,
                 affine[threadIdx.x]);
  }
  __syncthreads();

  const size_t in_plane = static_cast<size_t>(in_h) * in_w;
  const size_t object_stride = static_cast<size_t>(channels) * in_plane;
  const T* fb = feat + static_cast<size_t>(b) * n_objects * object_stride +
                static_cast<size_t>(c) * in_plane;
  T* ob = out + static_cast<size_t>(plane) * out_h * out_w;
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
      const float wy[2] = {weight<T>(1.0f - ty), weight<T>(ty)};
      const float wx[2] = {weight<T>(1.0f - tx), weight<T>(tx)};
      const T* fo = fb + static_cast<size_t>(o) * object_stride;
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
          row += wx[dx] * load(fo + static_cast<size_t>(yy) * in_w + xx);
        }
        v += wy[dy] * row;
      }
      acc += v;
    }
    store(ob + p, acc);
  }
}


// 1 - |src - p| clamped at 0; 0 for a non-finite src
__device__ __forceinline__ float hat(float src, int p) {
  return fmaxf(0.0f, 1.0f - fabsf(src - static_cast<float>(p)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stn_place_multi_grad_kernel(const T* __restrict__ grad,
                            const float* __restrict__ bbox,
                            T* __restrict__ dfeat, int n_objects,
                            int channels, int groups, int in_h, int in_w,
                            int out_h, int out_w) {
  __shared__ float affine[kMaxObjects][4];
  // src_y[o][i], src_x[o][j], then the tap ranges lo/hi of every input
  // row p and column q of every object; sized by the wrapper
  extern __shared__ float smem[];
  float* src_y = smem;
  float* src_x = src_y + n_objects * out_h;
  int* row_lo = reinterpret_cast<int*>(src_x + n_objects * out_w);
  int* row_hi = row_lo + n_objects * in_h;
  int* col_lo = row_hi + n_objects * in_h;
  int* col_hi = col_lo + n_objects * in_w;

  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * kGradChannels;
  if (threadIdx.x < n_objects) {
    place_affine(bbox + (static_cast<size_t>(b) * n_objects + threadIdx.x) * 4,
                 affine[threadIdx.x]);
  }
  __syncthreads();

  const int n_src = out_h + out_w;
  for (int t = threadIdx.x; t < n_objects * n_src; t += blockDim.x) {
    const int o = t / n_src;
    const int k = t - o * n_src;
    if (k < out_h) {
      src_y[o * out_h + k] = source_coord(affine[o][2], affine[o][3],
                                          grid_coord(k, out_h), in_h);
    } else {
      src_x[o * out_w + k - out_h] = source_coord(
          affine[o][0], affine[o][1], grid_coord(k - out_h, out_w), in_w);
    }
  }
  __syncthreads();

  const int n_in = in_h + in_w;
  for (int t = threadIdx.x; t < n_objects * n_in; t += blockDim.x) {
    const int o = t / n_in;
    const int k = t - o * n_in;
    const bool is_row = k < in_h;
    const int p = is_row ? k : k - in_h;
    const float* src = is_row ? src_y + o * out_h : src_x + o * out_w;
    const int n_out = is_row ? out_h : out_w;
    int lo = 0, hi = -1;                // empty
    for (int i = 0; i < n_out; ++i) {
      if (hat(src[i], p) > 0.0f) {
        if (hi < lo) lo = i;
        hi = i;
      }
    }
    if (is_row) {
      row_lo[o * in_h + p] = lo;
      row_hi[o * in_h + p] = hi;
    } else {
      col_lo[o * in_w + p] = lo;
      col_hi[o * in_w + p] = hi;
    }
  }
  __syncthreads();

  const int in_plane = in_h * in_w;
  const size_t out_plane = static_cast<size_t>(out_h) * out_w;
  const int work = kGradChannels * n_objects * in_plane;
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    const int q = t % in_w;
    int r = t / in_w;
    const int p = r % in_h;
    r /= in_h;
    const int o = r % n_objects;
    const int c = c0 + r / n_objects;
    if (c >= channels) continue;
    const T* gp = grad + (static_cast<size_t>(b) * channels + c) * out_plane;
    const float* sy = src_y + o * out_h;
    const float* sx = src_x + o * out_w;
    const int j_lo = col_lo[o * in_w + q];
    const int j_hi = col_hi[o * in_w + q];
    float acc = 0.0f;
    for (int i = row_lo[o * in_h + p]; i <= row_hi[o * in_h + p]; ++i) {
      const float wy = weight<T>(hat(sy[i], p));
      float row = 0.0f;
      for (int j = j_lo; j <= j_hi; ++j) {
        row += weight<T>(hat(sx[j], q)) *
               load(gp + static_cast<size_t>(i) * out_w + j);
      }
      acc += wy * row;
    }
    store(dfeat + ((static_cast<size_t>(b) * n_objects + o) * channels + c) *
                      in_plane + p * in_w + q,
          acc);
  }
}


template <typename T>
int place(const T* feat, const float* bbox, T* out, int batch, int n_objects,
          int channels, int in_h, int in_w, int out_h, int out_w,
          void* stream) {
  if (n_objects < 1 || n_objects > kMaxObjects) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long planes = static_cast<long long>(batch) * channels;
  if (planes < 1 || planes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stn_place_multi_kernel<T><<<static_cast<unsigned>(planes), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      feat, bbox, out, n_objects, channels, in_h, in_w, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int place_grad(const T* grad, const float* bbox, T* dfeat, int batch,
               int n_objects, int channels, int in_h, int in_w, int out_h,
               int out_w, void* stream) {
  if (n_objects < 1 || n_objects > kMaxObjects || batch < 1 || channels < 1 ||
      in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || in_h > kMaxSide ||
      in_w > kMaxSide || out_h > kMaxSide || out_w > kMaxSide) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (channels + kGradChannels - 1) / kGradChannels;
  const long long blocks = static_cast<long long>(batch) * groups;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(n_objects) * (out_h + out_w) * sizeof(float) +
      static_cast<size_t>(n_objects) * (in_h + in_w) * 2 * sizeof(int);
  stn_place_multi_grad_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, static_cast<cudaStream_t>(stream)>>>(
      grad, bbox, dfeat, n_objects, channels, groups, in_h, in_w, out_h,
      out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat (B, O, C, H, W), bbox (B, O, 4) f32, out (B, C, Ho, Wo): contiguous,
// on the current device; feat and out f32 (_f32) or bf16 (_bf16). Return
// cudaGetLastError() after the launch.
extern "C" int stn_place_multi_f32(const float* feat, const float* bbox,
                                   float* out, int batch, int n_objects,
                                   int channels, int in_h, int in_w, int out_h,
                                   int out_w, void* stream) {
  return place(feat, bbox, out, batch, n_objects, channels, in_h, in_w, out_h,
               out_w, stream);
}

extern "C" int stn_place_multi_bf16(const void* feat, const float* bbox,
                                    void* out, int batch, int n_objects,
                                    int channels, int in_h, int in_w,
                                    int out_h, int out_w, void* stream) {
  return place(static_cast<const bf16*>(feat), bbox, static_cast<bf16*>(out),
               batch, n_objects, channels, in_h, in_w, out_h, out_w, stream);
}

// grad (B, C, Ho, Wo), bbox (B, O, 4) f32, dfeat (B, O, C, H, W):
// contiguous, on the current device, every side at most kMaxSide; grad and
// dfeat f32 (_f32) or bf16 (_bf16). Return cudaGetLastError() after the
// launch.
extern "C" int stn_place_multi_grad_f32(const float* grad, const float* bbox,
                                        float* dfeat, int batch, int n_objects,
                                        int channels, int in_h, int in_w,
                                        int out_h, int out_w, void* stream) {
  return place_grad(grad, bbox, dfeat, batch, n_objects, channels, in_h, in_w,
                    out_h, out_w, stream);
}

extern "C" int stn_place_multi_grad_bf16(const void* grad, const float* bbox,
                                         void* dfeat, int batch, int n_objects,
                                         int channels, int in_h, int in_w,
                                         int out_h, int out_w, void* stream) {
  return place_grad(static_cast<const bf16*>(grad), bbox,
                    static_cast<bf16*>(dfeat), batch, n_objects, channels,
                    in_h, in_w, out_h, out_w, stream);
}
