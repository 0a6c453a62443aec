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
// canvas sends several outputs to one input pixel). Each weight comes from
// the same grid_coord/source_coord/place_affine as K1's, so forward and
// backward use the same coordinates bit for bit. A gather writes each value
// once with a fixed order of sums, so the result does not vary from run to
// run, as a scatter with atomics would.
//
// Bound: bytes for both. Each input value with a non-zero weight is read
// once from device memory and each output written once; a few operations
// per byte moved, far below the card's balance point. K1 need not read
// every input value: the train step's boxes are 0.2-0.33 of the canvas
// wide, so each object's taps fall on about half the input rows and half
// the columns, and its bound (chip_smoke.py:_bound) reads about a quarter
// of the input: at the G shape (128,3,256,16,16) -> (128,256,16,16) f32,
// 27.8 MB of the 100.7 MB input and the 33.5 MB output, 0.0183 ms at
// 3.35 TB/s, where reading every input value would take 0.040 ms. The
// columns with taps are spread over the whole row in pairs 1/w apart, and
// a 16-wide row is two 32-byte sectors in f32 and one in bf16, so only the
// rows are worth skipping. K2 at batch 128 reads at most 33.6 MB and writes
// 100.7 MB. In bf16 both move half that.
//
// Design: layout NCHW, the layout the model holds, so the model pays no
// permute.
// K1 (redesigned for its byte bound): the first design, one 256-thread
// block per (b, c) output plane, one output value a thread, was bound by
// latency and set-up, not bytes: 32,768 blocks at the G shape, each paying
// the box's affine (two divisions) and a barrier for four 1 KB planes;
// each value recomputing its coordinates per object; and scalar loads
// behind data-dependent branches, so a block waited on about three memory
// latencies in a row. bf16 ran no faster than f32. Now one block per (b,
// tile of channels), the tile sized from the map sides by the wrapper (16
// channels at 16x16 and 15x15, fewer for sides up to kMaxSide), so the
// set-up is paid once per 16 planes. One warp per object builds its tables
// in shared memory with K2's helpers (axis_source, first_taps): each
// output row's and column's two taps and weights, the spans of output
// rows and columns with taps, and the list of input rows with taps; and
// at once starts the copy of those rows, for the tile's channels, with
// 16-byte cp.async, so the three objects' rows are in flight together
// before the block's first barrier. Then per object the values inside its
// box are packed over the block's threads and added to the tile's sums in
// shared memory (a barrier between objects); values outside every box stay
// 0, with no arithmetic. The sums are written with 16-byte stores. Each
// value keeps the first design's order of sums (dx inside dy, then
// objects ascending, f32, one rounding on the store). A padded object
// (bbox = -1) has no rows with taps: it reads nothing and adds nothing.
// What bounds it now is latency, not bytes: a block waits on two memory
// round trips in a row (its boxes, then its rows) and on its barriers,
// and its shared memory (the staged planes and the sums) lets only three
// (f32) to five (bf16) blocks share an SM (chip_smoke.py phase 3 times
// it; PERF.md has the readings).
// K2 (redesigned for its byte bound too): one block per (b, tile of channels),
// the tile sized from the map sides by the wrapper (16 channels at the
// train step's shapes, fewer for sides up to kMaxSide), so the per-object
// set-up is paid once per 16 channels, not per 4. The block builds its
// tables once in shared memory: each output row's and column's first tap
// and the two hat weights it has (the only non-zero ones), and each input
// row's and column's tap range (marked from the outputs' taps with shared
// atomicMin/atomicMax, which give the same range in any order). It stages
// the tile's gradient planes, one contiguous run, with 16-byte loads. Then
// per object two separable passes through shared memory: T[c][i][q] =
// sum_j Wx[j, q] * g[c][i][j] for the output rows i that have taps, then
// dfeat[c][p][q] = sum_i Wy[i, p] * T[c][i][q], the order the first design
// summed in (j, then i), with every weight read from the tables. A thread
// owns one input column q and walks rows without divisions, so a column's
// taps (at most two for a box inside the canvas) sit in registers, and the
// rows' ranges and weights are broadcast reads. The (b, o, tile) output
// planes, one contiguous run, are gathered in shared memory and written
// with 16-byte stores where aligned. A padded object's ranges are empty,
// so it writes exact zeros.
// A box with a non-finite value gives non-finite sources, which have no
// taps in either kernel (first_taps weighs them 0: fmaxf(0, NaN) is 0):
// both skip the object, where the plain version gives NaN. The serving
// path rejects such boxes, and training data has none. The kernels
// allocate nothing and launch on the caller's stream.
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

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxObjects = 16;  // ops/stn_place_cuda.py:MAX_OBJECTS
constexpr int kThreads = 256;
constexpr int kMaxSide = 64;        // ops/stn_place_cuda.py:MAX_SIDE
constexpr int kMaxGradTile = 64;    // channels per K2 block, at most
constexpr int kMaxPlaceTile = 64;   // channels per K1 block, at most
// K1's dynamic shared memory, at most: the card's 227 KB a block
constexpr size_t kMaxPlaceSmem = 232448;
// K1's staging buffers: the rows of this many objects are in flight at once
constexpr int kStages = 3;
// K2's dynamic shared memory, at most: the card's 227 KB a block less the
// static affine table
constexpr size_t kMaxGradSmem = 232448 - kMaxObjects * 4 * sizeof(float);

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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

// 1 - |src - p| clamped at 0; 0 for a non-finite src
__device__ __forceinline__ float hat(float src, int p) {
  return fmaxf(0.0f, 1.0f - fabsf(src - static_cast<float>(p)));
}

// The source coordinate of output row k (is_row) or column k of an object
// with place affine sx, tx, sy, ty, on an axis of out_n outputs and in_n
// inputs (K2 writes the same two calls out, which keeps its registers).
__device__ __forceinline__ float axis_source(const float* affine, bool is_row,
                                             int k, int out_n, int in_n) {
  const float g = grid_coord(k, out_n);
  return is_row ? source_coord(affine[2], affine[3], g, in_n)
                : source_coord(affine[0], affine[1], g, in_n);
}

// An output row's or column's first tap p0 = floor(src) and the hat weights
// h0 of p0 and h1 of p0 + 1, the only two that can be non-zero. A source
// far outside the input, or not finite, has no non-zero weight; its p0 is
// clamped only to stay an int.
struct Taps {
  int p0;
  float h0, h1;
};

__device__ __forceinline__ Taps first_taps(float src, int n) {
  const int p0 = static_cast<int>(
      floorf(fminf(fmaxf(src, -2.0f), static_cast<float>(n) + 1.0f)));
  return {p0, hat(src, p0), hat(src, p0 + 1)};
}

// K1's table entry of an output row (column): its taps a, b inside the
// input with a non-zero weight, and their weights wa, wb as the element
// type holds them, as (a, b, wa, wb). A missing tap repeats the other with
// weight 0, so both name a row (column) that has taps; a = -1 when there
// is none. Adding 0 * f leaves a sum as it was, so each value is the first
// design's, whose taps at 1 - t and t had these weights: hat(src, p0) is
// 1 - t and hat(src, p0 + 1) is t, exactly.
template <typename T>
__device__ __forceinline__ int4 tap_entry(Taps t, int n) {
  const bool va = t.h0 > 0.0f && t.p0 >= 0 && t.p0 < n;
  const bool vb = t.h1 > 0.0f && t.p0 + 1 >= 0 && t.p0 + 1 < n;
  if (!va && !vb) return make_int4(-1, -1, 0, 0);
  const int a = va ? t.p0 : t.p0 + 1;
  return make_int4(a, vb ? t.p0 + 1 : a,
                   __float_as_int(va ? weight<T>(t.h0) : 0.0f),
                   __float_as_int(vb ? weight<T>(t.h1) : 0.0f));
}

// 16 bytes from global to shared memory, asynchronously (cp.async.cg:
// through L2 only); completion is awaited by group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// wait until every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K1 stages a tile of one object's input planes in a buffer of this many
// elements: the run rounded up to 16-byte chunks, and one chunk more for a
// run that does not start on a chunk
__host__ __device__ __forceinline__ int place_stage_elems(int tile, int in_h,
                                                          int in_w,
                                                          int elem_size) {
  const int v = 16 / elem_size;
  return (tile * in_h * in_w + v - 1) / v * v + v;
}

// K1's dynamic shared memory in bytes: the tables of every object in
// 16-byte entries (each output row's and column's taps; the object's span
// of output rows and columns with taps; its count of input rows with taps
// and the reciprocals that unpack its box), the tile's output sums in f32
// (rounded up to 16 bytes), a staging buffer in the element type for each
// of up to kStages objects, and each object's list of input rows with
// taps. ops/stn_place_cuda.py:place_smem_bytes counts the same.
__host__ __device__ __forceinline__ size_t place_smem_bytes(
    int n_objects, int tile, int in_h, int in_w, int out_h, int out_w,
    int elem_size) {
  return static_cast<size_t>(16) * n_objects * (out_h + out_w + 2) +
         static_cast<size_t>(4) * ((tile * out_h * out_w + 3) / 4 * 4) +
         static_cast<size_t>(n_objects < kStages ? n_objects : kStages) *
             place_stage_elems(tile, in_h, in_w, elem_size) * elem_size +
         static_cast<size_t>(4) * n_objects * in_h;
}

// Start the copy of the rows listed in rows[0 .. n_rows) of the cnt planes
// of in_h x in_w values at src into dst, by threads t = 0 .. n_threads - 1
// of a group: whole 16-byte chunks, so that dst[e] holds the value at
// src - off + e, off being src's distance in values from a chunk. The
// other rows' chunks are not read. A row touches at most cpr chunks; cpr
// threads copy a row, several rows each, all in flight at once.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* src, T* dst,
                                           const int* rows, int n_rows,
                                           int cnt, int in_h, int in_w, int t,
                                           int n_threads) {
  constexpr int kV = 16 / sizeof(T);
  const int off = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T));
  const T* base = src - off;
  const int cpr = off == 0 && in_w % kV == 0 ? in_w / kV
                                             : (in_w + 2 * kV - 2) / kV;
  const int slot = t / cpr;
  const int lane = t - slot * cpr;
  const int nslots = n_threads / cpr;
  if (slot >= nslots) return;
  // this thread's rows are the items slot, slot + nslots, ...; item
  // c * n_rows + r is rows[r] of channel c, stepped without a division
  const int cstep = nslots / n_rows;
  const int rstep = nslots - cstep * n_rows;
  int c = slot / n_rows;
  int r = slot - c * n_rows;
  const int plane = in_h * in_w;
  while (c < cnt) {
    const int start = off + c * plane + rows[r] * in_w;
    const int chunk = start / kV + lane;
    if (chunk <= (start + in_w - 1) / kV) {
      cp_async16(dst + chunk * kV, base + chunk * kV);
    }
    c += cstep;
    r += rstep;
    if (r >= n_rows) {
      r -= n_rows;
      ++c;
    }
  }
}

// a / d for 0 <= a < 2^18 and 1 <= d <= 2^12, from rcp = 1 / d rounded:
// (a + 0.5) / d lies at least 0.5 / d from an integer, and the float
// product errs by less than a / d * 2^-23 <= 2^-5 / d, so the truncation
// is exact. K1's a is at most 64 channels of a 64 x 64 box.
__device__ __forceinline__ int div_rcp(int a, float rcp) {
  return static_cast<int>((static_cast<float>(a) + 0.5f) * rcp);
}

// One warp's set-up of object o for K1: each output row's and column's
// table entry (two passes of 32 lanes cover sides up to 64), the spans of
// rows and columns with taps (ballots; the source is monotone, so they are
// contiguous), the input rows with taps (an OR over the lanes of the rows'
// taps; none when no column has a tap) listed ascending, and its meta:
// (rows with taps, box size, 1 / box size, 1 / box width).
template <typename T>
__device__ __forceinline__ void place_object_tables(
    const float* bb, int o, int in_h, int in_w, int out_h, int out_w,
    int4* rowtab, int4* coltab, int4* span, int4* meta, int* rows) {
  const int lane = threadIdx.x & 31;
  float affine[4];
  place_affine(bb, affine);
  int lo[2] = {0x7fffffff, 0x7fffffff};  // rows, columns
  int hi[2] = {-1, -1};
  unsigned long long taps = 0ull;        // input rows with taps, this lane's
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const bool is_row = axis == 0;
    const int out_n = is_row ? out_h : out_w;
    const int in_n = is_row ? in_h : in_w;
    int4* tab = (is_row ? rowtab + o * out_h : coltab + o * out_w);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = lane + 32 * half;
      bool ok = false;
      if (i < out_n) {
        const int4 e = tap_entry<T>(
            first_taps(axis_source(affine, is_row, i, out_n, in_n), in_n),
            in_n);
        tab[i] = e;
        ok = e.x >= 0;
        if (ok && is_row) taps |= (1ull << e.x) | (1ull << e.y);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      if (bits) {
        lo[axis] = min(lo[axis], 32 * half + __ffs(bits) - 1);
        hi[axis] = max(hi[axis], 32 * half + 31 - __clz(bits));
      }
    }
  }
  unsigned m[2] = {
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(taps)),
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(taps >> 32))};
  if (lo[1] > hi[1]) m[0] = m[1] = 0u;   // no column has a tap
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = lane + 32 * half;
    if (p < in_h && ((m[half] >> lane) & 1u)) {
      rows[o * in_h + (half ? __popc(m[0]) : 0) +
           __popc(m[half] & ((1u << lane) - 1u))] = p;
    }
  }
  if (lane == 0) {
    span[o] = make_int4(lo[0], hi[0], lo[1], hi[1]);
    const int nj = max(hi[1] - lo[1] + 1, 1);
    const int box = max(hi[0] - lo[0] + 1, 1) * nj;
    meta[o] = make_int4(__popc(m[0]) + __popc(m[1]), box,
                        __float_as_int(__frcp_rn(static_cast<float>(box))),
                        __float_as_int(__frcp_rn(static_cast<float>(nj))));
  }
  __syncwarp();
}

// K1, one block per (b, tile of channels). Warp o builds object o's tables
// and at once starts the copy of its rows with taps, so the first kStages
// objects' rows are in flight together without a barrier; the other
// warps zero the tile's sums meanwhile. Then per object the values inside
// its box, packed over the block's threads, are added to the sums in
// shared memory; the sums are written out with 16-byte stores.
// Objects past the first kStages are staged in further batches by the
// whole block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stn_place_multi_kernel(const T* __restrict__ feat,
                       const float* __restrict__ bbox, T* __restrict__ out,
                       int n_objects, int channels, int tile, int groups,
                       int in_h, int in_w, int out_h, int out_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int4* rowtab = reinterpret_cast<int4*>(smem_raw);     // [o][out_h]
  int4* coltab = rowtab + n_objects * out_h;            // [o][out_w]
  int4* span = coltab + n_objects * out_w;              // [o]: i, j ranges
  int4* meta = span + n_objects;                        // [o]
  float* acc = reinterpret_cast<float*>(meta + n_objects);  // [c][i][j]
  const int out_plane = out_h * out_w;
  const int stage = place_stage_elems(tile, in_h, in_w, sizeof(T));
  T* stg = reinterpret_cast<T*>(acc + (tile * out_plane + 3) / 4 * 4);
  int* rows = reinterpret_cast<int*>(stg + min(n_objects, kStages) * stage);

  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * tile;
  const int cnt = min(tile, channels - c0);
  const int in_plane = in_h * in_w;
  const int n_out = cnt * out_plane;
  const size_t obj_stride = static_cast<size_t>(channels) * in_plane;
  const T* run = feat + (static_cast<size_t>(b) * n_objects * channels + c0) *
                            in_plane;             // (b, 0, c0 .. c0 + cnt)
  const int warp = threadIdx.x >> 5;
  for (int o = warp; o < n_objects; o += blockDim.x >> 5) {
    place_object_tables<T>(bbox + (static_cast<size_t>(b) * n_objects + o) * 4,
                           o, in_h, in_w, out_h, out_w, rowtab, coltab, span,
                           meta, rows);
    if (o < kStages && meta[o].x > 0) {
      stage_rows(run + o * obj_stride, stg + o * stage, rows + o * in_h,
                 meta[o].x, cnt, in_h, in_w, threadIdx.x & 31, 32);
    }
  }
  // every sum starts at 0: a value outside every box is written as 0
  for (int e = threadIdx.x; e < (n_out + 3) / 4; e += blockDim.x) {
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int o0 = 0; o0 < n_objects; o0 += kStages) {
    const int n_batch = min(kStages, n_objects - o0);
    if (o0 > 0) {
      for (int s = 0; s < n_batch; ++s) {
        const int o = o0 + s;
        if (meta[o].x > 0) {
          stage_rows(run + o * obj_stride, stg + s * stage, rows + o * in_h,
                     meta[o].x, cnt, in_h, in_w, threadIdx.x, blockDim.x);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();                      // the batch's rows and the tables
    for (int s = 0; s < n_batch; ++s) {
      const int o = o0 + s;
      const int4 mt = meta[o];
      if (mt.x == 0) continue;            // no taps: adds nothing
      const int4 sp = span[o];
      const int nj = sp.w - sp.z + 1;
      const float rcp_box = __int_as_float(mt.z);
      const float rcp_nj = __int_as_float(mt.w);
      const T* f = stg + s * stage +
                   (reinterpret_cast<uintptr_t>(run + o * obj_stride) % 16) /
                       sizeof(T);
      const int4* rt = rowtab + o * out_h;
      const int4* ct = coltab + o * out_w;
      // the values (c, i, j) of the box, j fastest
      for (int e = threadIdx.x; e < cnt * mt.y; e += blockDim.x) {
        const int c = div_rcp(e, rcp_box);
        const int r = e - c * mt.y;
        const int ii = div_rcp(r, rcp_nj);
        const int i = sp.x + ii;
        const int j = sp.z + r - ii * nj;
        const int4 ry = rt[i];
        const int4 cx = ct[j];
        const T* fa = f + c * in_plane + ry.x * in_w;
        const T* fb = f + c * in_plane + ry.y * in_w;
        const float wxa = __int_as_float(cx.z);
        const float wxb = __int_as_float(cx.w);
        float r0 = 0.0f;
        r0 += wxa * to_f32(fa[cx.x]);
        r0 += wxb * to_f32(fa[cx.y]);
        float r1 = 0.0f;
        r1 += wxa * to_f32(fb[cx.x]);
        r1 += wxb * to_f32(fb[cx.y]);
        float v = 0.0f;
        v += __int_as_float(ry.z) * r0;
        v += __int_as_float(ry.w) * r1;
        acc[c * out_plane + i * out_w + j] += v;
      }
      __syncthreads();                    // the next object adds to the sums
    }
  }

  // the (b, c0 .. c0 + cnt) output planes are one contiguous run: 16-byte
  // stores where aligned, single ones around them
  constexpr int kV = 16 / sizeof(T);
  T* ob = out + (static_cast<size_t>(b) * channels + c0) * out_plane;
  const int head = min(n_out, static_cast<int>(
      ((16 - reinterpret_cast<uintptr_t>(ob) % 16) % 16) / sizeof(T)));
  const int nv = (n_out - head) / kV;
  for (int e = threadIdx.x; e < head; e += blockDim.x) store(ob + e, acc[e]);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const float* src = acc + head + v * kV;
    uint4 packed;
    T* vals = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int k = 0; k < kV; ++k) store(vals + k, src[k]);
    *reinterpret_cast<uint4*>(ob + head + v * kV) = packed;
  }
  for (int e = head + nv * kV + threadIdx.x; e < n_out; e += blockDim.x) {
    store(ob + e, acc[e]);
  }
}

// K2's shared memory in 4-byte words for a tile of channels: the tile's
// gradient planes, one object's row sums T and its output planes in f32,
// then the tables of every object (the first tap and its two weights of
// each output row and column, the tap range of each input row and column,
// the first and last output row that has taps, and each input row's taps).
// ops/stn_place_cuda.py:grad_smem_bytes counts the same.
__host__ __device__ __forceinline__ int grad_smem_words(int n_objects,
                                                        int tile, int in_h,
                                                        int in_w, int out_h,
                                                        int out_w) {
  return tile * (out_h * (out_w + in_w) + in_h * in_w) +
         n_objects * (3 * (out_h + out_w) + 2 * (in_h + in_w) + 2 + 4 * in_h);
}

// n values of the element type from global memory at src, as f32 into
// shared memory at dst: 16-byte loads where aligned, four in flight a
// thread, single ones around them
template <typename T>
__device__ void stage_f32(const T* __restrict__ src, float* dst, int n) {
  constexpr int kV = 16 / sizeof(T);
  const int head = min(n, static_cast<int>(
      ((16 - reinterpret_cast<uintptr_t>(src) % 16) % 16) / sizeof(T)));
  const int nv = (n - head) / kV;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  for (int v0 = threadIdx.x; v0 < nv; v0 += 4 * blockDim.x) {
    uint4 raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = v0 + k * blockDim.x;
      if (v < nv) raw[k] = __ldg(vsrc + v);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = v0 + k * blockDim.x;
      if (v >= nv) break;
      const T* in = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
      for (int e = 0; e < kV; ++e) dst[head + v * kV + e] = to_f32(in[e]);
    }
  }
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = load(src + e);
  for (int e = head + nv * kV + threadIdx.x; e < n; e += blockDim.x) {
    dst[e] = load(src + e);
  }
}

// K2, one block per (b, tile of channels): the tables once, the tile's
// gradient planes staged once, then per object the two separable passes
//   T[c][i][q] = sum_j Wx[j, q] * g[c][i][j]      (j ascending)
//   dfeat[c][p][q] = sum_i Wy[i, p] * T[c][i][q]  (i ascending)
// over the tap ranges, each weight read from the tables. A thread owns one
// input column q, so its column's range and weights stay in registers, and
// walks rows; T is computed only for the output rows i that have taps.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stn_place_multi_grad_kernel(const T* __restrict__ grad,
                            const float* __restrict__ bbox,
                            T* __restrict__ dfeat, int n_objects,
                            int channels, int tile, int groups, int in_h,
                            int in_w, int out_h, int out_w) {
  __shared__ float affine[kMaxObjects][4];
  extern __shared__ float smem[];
  const int out_plane = out_h * out_w;
  const int in_plane = in_h * in_w;
  // [o][in_h]: an input row's taps when it has one or two: (ia, ib, wa,
  // wb) with a zero weight for a missing tap; ia = -1 for more, -2 for none
  int4* rtap = reinterpret_cast<int4*>(smem);
  float* gs = smem + 4 * n_objects * in_h;        // [tile][out_h][out_w]
  float* ts = gs + tile * out_plane;              // [tile][ni][in_w]
  float* os = ts + tile * out_h * in_w;           // [tile][in_h][in_w]
  float* wy0 = os + tile * in_plane;              // [o][out_h]: weight of
  float* wy1 = wy0 + n_objects * out_h;           // tap p0, of p0 + 1
  float* wx0 = wy1 + n_objects * out_h;           // [o][out_w]
  float* wx1 = wx0 + n_objects * out_w;
  int* py0 = reinterpret_cast<int*>(wx1 + n_objects * out_w);  // floor(src)
  int* px0 = py0 + n_objects * out_h;
  int* row_lo = px0 + n_objects * out_w;          // [o][in_h]: tap range
  int* row_hi = row_lo + n_objects * in_h;
  int* col_lo = row_hi + n_objects * in_h;        // [o][in_w]
  int* col_hi = col_lo + n_objects * in_w;
  int* rows = col_hi + n_objects * in_w;          // [o]: output rows with taps

  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * tile;
  const int cnt = min(tile, channels - c0);
  if (threadIdx.x < n_objects) {
    place_affine(bbox + (static_cast<size_t>(b) * n_objects + threadIdx.x) * 4,
                 affine[threadIdx.x]);
  }
  // every range starts empty (lo > hi)
  for (int t = threadIdx.x; t < n_objects * in_h; t += blockDim.x) {
    row_lo[t] = 0x7fffffff;
    row_hi[t] = -1;
  }
  for (int t = threadIdx.x; t < n_objects * in_w; t += blockDim.x) {
    col_lo[t] = 0x7fffffff;
    col_hi[t] = -1;
  }
  for (int t = threadIdx.x; t < n_objects; t += blockDim.x) {
    rows[2 * t] = 0x7fffffff;
    rows[2 * t + 1] = -1;
  }
  // the tile's gradient planes are one contiguous run
  stage_f32(grad + (static_cast<size_t>(b) * channels + c0) * out_plane, gs,
            cnt * out_plane);
  __syncthreads();

  // every output row's and column's first tap p0 and the two weights
  // weight<T>(hat(src, p0)), weight<T>(hat(src, p0 + 1)), the only non-zero
  // ones; and each input row's (column's) tap range, the outputs with a
  // non-zero weight on it. The source is monotone, so these are
  // contiguous; atomicMin and atomicMax give the same range in any order,
  // the range a search of every output's weight finds, so any box works,
  // however wide.
  const int n_src = out_h + out_w;
  for (int t = threadIdx.x; t < n_objects * n_src; t += blockDim.x) {
    const int o = t / n_src;
    const int k = t - o * n_src;
    const bool is_row = k < out_h;
    const int i = is_row ? k : k - out_h;
    const int n = is_row ? in_h : in_w;
    const float src =
        is_row ? source_coord(affine[o][2], affine[o][3],
                              grid_coord(i, out_h), in_h)
               : source_coord(affine[o][0], affine[o][1],
                              grid_coord(i, out_w), in_w);
    const Taps tap = first_taps(src, n);
    const int p0 = tap.p0;
    const float h0 = tap.h0;
    const float h1 = tap.h1;
    int* lo = is_row ? row_lo + o * in_h : col_lo + o * in_w;
    int* hi = is_row ? row_hi + o * in_h : col_hi + o * in_w;
    if (is_row) {
      py0[o * out_h + i] = p0;
      wy0[o * out_h + i] = weight<T>(h0);
      wy1[o * out_h + i] = weight<T>(h1);
    } else {
      px0[o * out_w + i] = p0;
      wx0[o * out_w + i] = weight<T>(h0);
      wx1[o * out_w + i] = weight<T>(h1);
    }
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int p = p0 + d;
      if (!((d == 0 ? h0 : h1) > 0.0f) || p < 0 || p >= n) continue;
      atomicMin(lo + p, i);
      atomicMax(hi + p, i);
      if (is_row) {
        atomicMin(rows + 2 * o, i);
        atomicMax(rows + 2 * o + 1, i);
      }
    }
  }
  __syncthreads();

  // each input row's taps for pass 2, in one 16-byte read where it has one
  // or two (always, for a box inside the canvas); else the range loop
  for (int t = threadIdx.x; t < n_objects * in_h; t += blockDim.x) {
    const int o = t / in_h;
    const int p = t - o * in_h;
    const int lo = row_lo[t];
    const int hi = row_hi[t];
    int4 tap = make_int4(-1, 0, 0, 0);
    if (lo > hi) {                    // no taps
      tap.x = -2;
    } else if (hi - lo <= 1) {
      const int k0 = o * out_h + lo;
      const int k1 = o * out_h + hi;
      const float wa = py0[k0] == p ? wy0[k0] : wy1[k0];
      const float wb = lo < hi ? (py0[k1] == p ? wy0[k1] : wy1[k1]) : 0.0f;
      tap = make_int4(lo, hi, __float_as_int(wa), __float_as_int(wb));
    }
    rtap[t] = tap;
  }
  __syncthreads();

  // this thread's column q and first row; it owns rows r0, r0 + rstep, ...
  // of each pass and walks the tile's channels in each
  const int q = threadIdx.x % in_w;
  const int r0 = threadIdx.x / in_w;
  const int rstep = blockDim.x / in_w;
  const int r_end = r0 < rstep ? 0x7fffffff : 0;  // threads past rstep idle
  constexpr int kV = 16 / sizeof(T);
  const int n_out = cnt * in_plane;
  for (int o = 0; o < n_objects; ++o) {
    const int ilo = rows[2 * o];
    const int ni = rows[2 * o + 1] - ilo + 1;  // <= 0: no taps at all
    // pass 1: T[c][i][q] for the output rows i with taps
    if (r0 < min(ni, r_end)) {
      const int jlo = col_lo[o * in_w + q];
      const int jhi = col_hi[o * in_w + q];
      const int* pxo = px0 + o * out_w;
      const float* wx0o = wx0 + o * out_w;
      const float* wx1o = wx1 + o * out_w;
      // in the range, p0 is q or q - 1; a column with at most two taps
      // keeps them in registers (a zero weight adds an exact 0)
      const bool two = jhi - jlo <= 1;
      const int ja = two && jlo <= jhi ? jlo : 0;
      const int jb = two && jlo < jhi ? jhi : ja;
      const float wa = two && jlo <= jhi
                           ? (pxo[ja] == q ? wx0o[ja] : wx1o[ja]) : 0.0f;
      const float wb = two && jlo < jhi
                           ? (pxo[jb] == q ? wx0o[jb] : wx1o[jb]) : 0.0f;
      for (int ii = r0; ii < ni; ii += rstep) {
        const float* g = gs + (ilo + ii) * out_w;
        float* dst = ts + ii * in_w + q;
        for (int c = 0; c < cnt; ++c, g += out_plane, dst += ni * in_w) {
          float row = 0.0f;
          if (two) {
            row += wa * g[ja];
            row += wb * g[jb];
          } else {
            for (int j = jlo; j <= jhi; ++j) {
              row += (pxo[j] == q ? wx0o[j] : wx1o[j]) * g[j];
            }
          }
          *dst = row;
        }
      }
    }
    __syncthreads();

    // pass 2: every value of the tile's output planes, into os
    const int* pyo = py0 + o * out_h;
    const float* wy0o = wy0 + o * out_h;
    const float* wy1o = wy1 + o * out_h;
    for (int p = r0; p < min(in_h, r_end); p += rstep) {
      const int4 tap = rtap[o * in_h + p];
      float* dst = os + p * in_w + q;
      if (tap.x == -2) {              // no taps
        for (int c = 0; c < cnt; ++c) dst[c * in_plane] = 0.0f;
        continue;
      }
      // T[c][i][q] is tc[c * ni * in_w + i * in_w]
      const float* tc = ts + (q - ilo * in_w);
      if (tap.x >= 0) {               // one or two taps
        const float wa = __int_as_float(tap.z);
        const float wb = __int_as_float(tap.w);
        const float* ta = tc + tap.x * in_w;
        const float* tb = tc + tap.y * in_w;
        for (int c = 0; c < cnt; ++c) {
          float acc = 0.0f;
          acc += wa * ta[c * ni * in_w];
          acc += wb * tb[c * ni * in_w];
          dst[c * in_plane] = acc;
        }
      } else {                        // more: the range
        const int lo = row_lo[o * in_h + p];
        const int hi = row_hi[o * in_h + p];
        for (int c = 0; c < cnt; ++c) {
          float acc = 0.0f;
          for (int i = lo; i <= hi; ++i) {
            acc += (pyo[i] == p ? wy0o[i] : wy1o[i]) *
                   tc[(c * ni + i) * in_w];
          }
          dst[c * in_plane] = acc;
        }
      }
    }
    __syncthreads();

    // the (b, o, c0..c0+cnt) planes are one contiguous run of the output:
    // 16-byte stores where aligned, single ones around them
    T* out = dfeat + ((static_cast<size_t>(b) * n_objects + o) * channels +
                      c0) * in_plane;
    const int head = min(n_out, static_cast<int>(
        ((16 - reinterpret_cast<uintptr_t>(out) % 16) % 16) / sizeof(T)));
    const int nv = (n_out - head) / kV;
    for (int e = threadIdx.x; e < head; e += blockDim.x) store(out + e, os[e]);
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      const float* src = os + head + v * kV;
      uint4 packed;
      T* vals = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int k = 0; k < kV; ++k) store(vals + k, src[k]);
      *reinterpret_cast<uint4*>(out + head + v * kV) = packed;
    }
    for (int e = head + nv * kV + threadIdx.x; e < n_out; e += blockDim.x) {
      store(out + e, os[e]);
    }
    __syncthreads();                  // ts and os are rewritten for o + 1
  }
}


template <typename T>
int place(const T* feat, const float* bbox, T* out, int batch, int n_objects,
          int channels, int in_h, int in_w, int out_h, int out_w, int tile,
          void* stream) {
  if (n_objects < 1 || n_objects > kMaxObjects || batch < 1 || channels < 1 ||
      in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || in_h > kMaxSide ||
      in_w > kMaxSide || out_h > kMaxSide || out_w > kMaxSide || tile < 1 ||
      tile > kMaxPlaceTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (channels + tile - 1) / tile;
  const long long n_tiles = static_cast<long long>(batch) * groups;
  const size_t smem = place_smem_bytes(n_objects, tile, in_h, in_w, out_h,
                                       out_w, sizeof(T));
  if (n_tiles > 0x7fffffffLL || smem > kMaxPlaceSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stn_place_multi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stn_place_multi_kernel<T><<<static_cast<unsigned>(n_tiles), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      feat, bbox, out, n_objects, channels, tile, groups, in_h, in_w, out_h,
      out_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int place_grad(const T* grad, const float* bbox, T* dfeat, int batch,
               int n_objects, int channels, int in_h, int in_w, int out_h,
               int out_w, int tile, void* stream) {
  if (n_objects < 1 || n_objects > kMaxObjects || batch < 1 || channels < 1 ||
      in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || in_h > kMaxSide ||
      in_w > kMaxSide || out_h > kMaxSide || out_w > kMaxSide || tile < 1 ||
      tile > kMaxGradTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (channels + tile - 1) / tile;
  const long long blocks = static_cast<long long>(batch) * groups;
  const size_t smem = static_cast<size_t>(grad_smem_words(
                          n_objects, tile, in_h, in_w, out_h, out_w)) *
                      sizeof(float);
  if (blocks > 0x7fffffffLL || smem > kMaxGradSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stn_place_multi_grad_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stn_place_multi_grad_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, static_cast<cudaStream_t>(stream)>>>(
      grad, bbox, dfeat, n_objects, channels, tile, groups, in_h, in_w,
      out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat (B, O, C, H, W), bbox (B, O, 4) f32, out (B, C, Ho, Wo): contiguous,
// on the current device, every side at most kMaxSide; feat and out f32
// (_f32) or bf16 (_bf16); tile channels a block, at most kMaxPlaceTile,
// with place_smem_bytes within kMaxPlaceSmem
// (ops/stn_place_cuda.py:place_tile). Return cudaGetLastError() after the
// launch.
extern "C" int stn_place_multi_f32(const float* feat, const float* bbox,
                                   float* out, int batch, int n_objects,
                                   int channels, int in_h, int in_w, int out_h,
                                   int out_w, int tile, void* stream) {
  return place(feat, bbox, out, batch, n_objects, channels, in_h, in_w, out_h,
               out_w, tile, stream);
}

extern "C" int stn_place_multi_bf16(const void* feat, const float* bbox,
                                    void* out, int batch, int n_objects,
                                    int channels, int in_h, int in_w,
                                    int out_h, int out_w, int tile,
                                    void* stream) {
  return place(static_cast<const bf16*>(feat), bbox, static_cast<bf16*>(out),
               batch, n_objects, channels, in_h, in_w, out_h, out_w, tile,
               stream);
}

// grad (B, C, Ho, Wo), bbox (B, O, 4) f32, dfeat (B, O, C, H, W):
// contiguous, on the current device, every side at most kMaxSide; grad and
// dfeat f32 (_f32) or bf16 (_bf16); tile channels a block, at most
// kMaxGradTile, with grad_smem_words within kMaxGradSmem
// (ops/stn_place_cuda.py:grad_tile). Return cudaGetLastError() after the
// launch.
extern "C" int stn_place_multi_grad_f32(const float* grad, const float* bbox,
                                        float* dfeat, int batch, int n_objects,
                                        int channels, int in_h, int in_w,
                                        int out_h, int out_w, int tile,
                                        void* stream) {
  return place_grad(grad, bbox, dfeat, batch, n_objects, channels, in_h, in_w,
                    out_h, out_w, tile, stream);
}

extern "C" int stn_place_multi_grad_bf16(const void* grad, const float* bbox,
                                         void* dfeat, int batch, int n_objects,
                                         int channels, int in_h, int in_w,
                                         int out_h, int out_w, int tile,
                                         void* stream) {
  return place_grad(static_cast<const bf16*>(grad), bbox,
                    static_cast<bf16*>(dfeat), batch, n_objects, channels,
                    in_h, in_w, out_h, out_w, tile, stream);
}
