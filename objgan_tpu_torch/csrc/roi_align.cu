// ROI-align forward (K2) and backward (K3) over channels-last features, for
// sm_90a.
//
// K2 replaces objgan_tpu/ops/roi_align.py::_fwd_kernel and K3 replaces
// ::_bwd_kernel (the Pallas TPU kernels that _pallas_fwd and _pallas_bwd
// launch). Semantics are those of _pool_matrix and of the twins in
// objgan_tpu_torch/ops/roi_align.py: torchvision roi_align with
// aligned=True. Along each axis of n pixels, bin r of R averages q samples at
//   src = origin*n + (r*q + k + 0.5) * extent*n / (R*q) - 0.5,
// a sample outside [-1, n] contributes zero, one inside is clamped to
// [0, n-1] and weighs its two neighbouring pixels bilinearly. An all-zero
// (padded) box therefore returns the top-left pixel's features.
//
// Bound: device-memory bytes. Per output element K2 does a few dozen
// multiply-adds, so the least time is the feature reads and the output
// write; K3 likewise reads the cotangent and writes df once. Sampling the
// features straight from L2 would request up to 4q^2 vectors per output
// (41-64 MB per train-step call for 2-4 MB touched). Both kernels instead
// take the TPU kernels' A_y @ F @ A_x^T one axis at a time through shared
// memory, each input read from L2 about once per block, in one wave at
// the train step, with their tables built by many threads at once;
// what is left is the blocks' own instruction and barrier latency. The
// launch plans come from ops/roi_align.py::fwd_plan and bwd_plan.
//
// K2: one block per (b, o, channel tile). Warp 0 builds the box's merged
//     taps: per axis and bin, the <= 2q distinct pixels its samples weigh
//     and their summed weights (zero weights dropped). Every thread finds
//     the box's footprint from its first and last samples. Then, patch by
//     patch of the footprint (rows x chunk pixels):
//       copy         the patch into shared memory, cp.async, 16 bytes a
//                    thread along channels;
//       row pass     t[i, x, c] = sum_y A_y[i, y] F[b, y, x, c] into fp32
//                    shared memory, a thread per (column, channel vector);
//       column pass  out[i, j, c] += sum_x A_x[j, x] t[i, x, c] in fp32
//                    registers;
//     and one rounded 16-byte store per output vector.
// K3: one block per (b, band of df rows, range of columns, channel tile);
//     each df element has exactly one owner, so there are no atomics and no
//     memset. All threads build A_y over the band's rows and A_x over the
//     block's columns (a thread per box, axis and bin adds its samples'
//     weights in order), then per bin the band rows it weighs and per
//     column its bins; a warp per box finds the box's rows of g that meet
//     the block and copies them into shared memory (cp.async). After a
//     barrier the thread of each (column, channel vector) sums, at its
//     rows y, A_y[i, y] * sum_j A_x[j, x] g[o, i, j, c] in fp32 registers
//     in a fixed order (o, then i, then j ascending), and rounds once.
//     Outputs that no box touches get zeros. Bit-reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The same numbers as ops/roi_align.py's _FWD_THREADS, _BWD_THREADS,
// _FWD_OWN and _BWD_OWN.
constexpr int kFwdThreads = 128;
constexpr int kFwdThreadsLog2 = 7;
constexpr int kBwdThreads = 256;
constexpr int kFwdOwn = 4;  // output vectors a K2 thread keeps in registers
constexpr int kBwdOwn = 8;  // df vectors a K3 thread keeps in registers
constexpr int kWarps = kBwdThreads / 32;
constexpr int kMaxSmem = 232448;  // opt-in shared memory of a block, H100

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void fma_vec(const T* p, float w,
                                        float (&acc)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = fmaf(w, to_f32(pk.v[j]), acc[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int j = 0; j < V; ++j) pk.v[j] = from_f32<T>(in[j]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// V fp32 values to or from shared memory, as float4s where V allows.
template <int V>
__device__ __forceinline__ void put_f32(float* p, const float (&in)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(in[j], in[j + 1], in[j + 2], in[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = in[j];
  }
}

template <int V>
__device__ __forceinline__ void fma_f32(const float* p, float w,
                                        float (&acc)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      acc[j] = fmaf(w, v.x, acc[j]);
      acc[j + 1] = fmaf(w, v.y, acc[j + 1]);
      acc[j + 2] = fmaf(w, v.z, acc[j + 2]);
      acc[j + 3] = fmaf(w, v.w, acc[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = fmaf(w, p[j], acc[j]);
  }
}

// Sample `idx` = r*q + k along an axis of n pixels: its low pixel and the
// weights of the low and high pixels, each divided by q (the bin average).
// The arithmetic follows the twin's operation order, rounded the same way
// (no contraction into fused multiply-adds).
__device__ __forceinline__ void axis_sample(float origin, float extent, int n,
                                            int fine, int idx, float inv_q,
                                            int* lo, float* w_lo,
                                            float* w_hi) {
  const float nf = (float)n;
  float src = __fmul_rn(__fadd_rn((float)idx, 0.5f), extent);
  src = __fdiv_rn(__fmul_rn(src, nf), (float)fine);
  src = __fadd_rn(__fmul_rn(origin, nf), src);
  src = __fsub_rn(src, 0.5f);
  const float inside = (src >= -1.f && src <= nf) ? 1.f : 0.f;
  const float sc = fminf(fmaxf(src, 0.f), nf - 1.f);
  int l = (int)floorf(sc);
  if (l > n - 1) l = n - 1;
  const float frac = sc - (float)l;
  *lo = l;
  *w_lo = (1.f - frac) * inside * inv_q;
  *w_hi = (l + 1 < n) ? frac * inside * inv_q : 0.f;
}

// Merged taps of bin r along an axis: the distinct pixels that the bin's q
// samples weigh, in the order first met, with their weights summed in
// sample order; zero weights are dropped. The rest of the 2q slots repeat
// the first pixel (pixel 0 if none) with weight 0.
__device__ void bin_taps(float origin, float extent, int n, int R, int q,
                         int r, float inv_q, int* pix, float* wt) {
  int cnt = 0;
  for (int k = 0; k < q; ++k) {
    int l;
    float w2[2];
    axis_sample(origin, extent, n, R * q, r * q + k, inv_q, &l, &w2[0],
                &w2[1]);
    for (int d = 0; d < 2; ++d) {
      if (w2[d] == 0.f) continue;
      int e = 0;
      while (e < cnt && pix[e] != l + d) ++e;
      if (e == cnt) {
        pix[cnt] = l + d;
        wt[cnt++] = w2[d];
      } else {
        wt[e] += w2[d];
      }
    }
  }
  for (int e = cnt; e < 2 * q; ++e) {
    pix[e] = cnt ? pix[0] : 0;
    wt[e] = 0.f;
  }
}

// bin_taps for q == Q known to the compiler, built in registers.
template <int Q>
__device__ __forceinline__ void bin_taps_q(float origin, float extent, int n,
                                           int R, int r, float inv_q,
                                           int* pix, float* wt) {
  int p[2 * Q];
  float w[2 * Q];
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < 2 * Q; ++e) {
    p[e] = 0;
    w[e] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    int l;
    float w2[2];
    axis_sample(origin, extent, n, R * Q, r * Q + k, inv_q, &l, &w2[0],
                &w2[1]);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (w2[d] == 0.f) continue;
      bool found = false;
#pragma unroll
      for (int e = 0; e < 2 * Q; ++e)
        if (e < cnt && p[e] == l + d) {
          w[e] += w2[d];
          found = true;
        }
      if (!found) {
#pragma unroll
        for (int e = 0; e < 2 * Q; ++e)
          if (e == cnt) {
            p[e] = l + d;
            w[e] = w2[d];
          }
        ++cnt;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 2 * Q; ++e) {
    pix[e] = e < cnt ? p[e] : (cnt ? p[0] : 0);
    wt[e] = e < cnt ? w[e] : 0.f;
  }
}

__host__ __device__ size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Copies V elements from global to shared memory: cp.async of 16 bytes
// (completed by stage_wait), else plain loads and stores.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = src[j];
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K2's dynamic shared memory: t (R, chunk, tile * V) fp32; the feature
// patch (rows, chunk, tile * V) in the I/O dtype; the taps of both axes
// (weights and pixels, 2 x (2, R, 2q)) and the footprint's ends (4 ints).
__host__ __device__ size_t fwd_data_bytes(int R, int rows, int chunk,
                                           int tile_channels, int itemsize) {
  return align16(4 * (size_t)R * chunk * tile_channels +
                 (size_t)rows * chunk * tile_channels * itemsize);
}

size_t fwd_smem_bytes(int R, int q, int rows, int chunk, int tile_channels,
                      int itemsize) {
  return fwd_data_bytes(R, rows, chunk, tile_channels, itemsize) +
         4 * (8 * (size_t)R * q + 4);
}

// The pixels [lo, hi] along an axis that some sample of the box can
// weigh: those of its first and last samples and all between (the sample
// positions are monotonic in their index).
__device__ __forceinline__ void axis_extent(float origin, float extent, int n,
                                            int fine, int* lo, int* hi) {
  int l0, l1;
  float w0, w1;
  axis_sample(origin, extent, n, fine, 0, 1.f, &l0, &w0, &w1);
  axis_sample(origin, extent, n, fine, fine - 1, 1.f, &l1, &w0, &w1);
  *lo = min(l0, l1);
  *hi = min(max(l0, l1) + 1, n - 1);
}

// Q > 0: q == Q, known to the compiler; Q == 0: any q. `tile` is a power
// of two: thread t takes channel vector t % tile, and column (row pass) or
// bins (column pass) t / tile.
template <typename T, int V, int Q>
__global__ void __launch_bounds__(kFwdThreads)
    roi_fwd_kernel(const T* __restrict__ f, const float* __restrict__ boxes,
                   T* __restrict__ out, int H, int W, int C, int O, int R,
                   int q, int tile, int rows, int chunk) {
  extern __shared__ float4 smem4[];
  const int taps = Q > 0 ? 2 * Q : 2 * q;
  const int tc = tile * V;
  float* tbuf = reinterpret_cast<float*>(smem4);  // (R, chunk, tc)
  T* patch = reinterpret_cast<T*>(tbuf + (size_t)R * chunk * tc);
  float* wts = reinterpret_cast<float*>(  // (2, R, taps): y, then x
      reinterpret_cast<char*>(smem4) +
      fwd_data_bytes(R, rows, chunk, tc, sizeof(T)));
  int* pix = reinterpret_cast<int*>(wts + 2 * R * taps);
  const int bo = blockIdx.x, b = bo / O;
  const int nvec = C / V, v0 = blockIdx.y * tile;
  const int tv = min(tile, nvec - v0);
  const int lt = __ffs(tile) - 1;
  const int cv = threadIdx.x & (tile - 1), grp = threadIdx.x >> lt;
  const float* box = boxes + (size_t)bo * 4;  // (x0, y0, w, h)
  // every thread: the footprint, which bounds the patches
  int y_lo, y_hi, x_lo, x_hi;
  axis_extent(box[1], box[3], H, R * q, &y_lo, &y_hi);
  axis_extent(box[0], box[2], W, R * q, &x_lo, &x_hi);
  const T* fb = f + (size_t)b * H * W * C + (size_t)v0 * V;
  if (threadIdx.x < 32) {
    const float inv_q = 1.f / (float)q;
    for (int t = threadIdx.x; t < 2 * R; t += 32) {
      const int axis = t / R, r = t % R;  // axis 0 = y, 1 = x
      const float origin = axis ? box[0] : box[1];
      const float extent = axis ? box[2] : box[3];
      if constexpr (Q > 0)
        bin_taps_q<Q>(origin, extent, axis ? W : H, R, r, inv_q,
                      pix + t * taps, wts + t * taps);
      else
        bin_taps(origin, extent, axis ? W : H, R, q, r, inv_q,
                 pix + t * taps, wts + t * taps);
    }
  }
  float acc[kFwdOwn][V];
#pragma unroll
  for (int s = 0; s < kFwdOwn; ++s)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[s][e] = 0.f;

  for (int c0 = x_lo; c0 <= x_hi; c0 += chunk) {
    const int cw = min(chunk, x_hi + 1 - c0);
    // row pass, `rows` footprint rows at a time: the patch of features
    // comes into shared memory once (cp.async), then the thread of
    // (column grp, vector cv) sums each bin's y taps from it into t
    for (int r0 = y_lo; r0 <= y_hi; r0 += rows) {
      const int rh = min(rows, y_hi + 1 - r0);
      if (c0 > x_lo || r0 > y_lo) __syncthreads();  // patch, t are free
      if (grp < cw && cv < tv)  // this thread's column and vector
        for (int y = 0; y < rh; ++y)
          stage<T, V>(patch + ((size_t)y * chunk + grp) * tc + cv * V,
                      fb + ((size_t)(r0 + y) * W + c0 + grp) * C +
                          (size_t)cv * V);
      stage_wait();
      __syncthreads();
      if (grp < cw && cv < tv) {
        const T* col = patch + (size_t)grp * tc + cv * V;
        float* tp = tbuf + (size_t)grp * tc + cv * V;
        for (int i = 0; i < R; ++i) {
          const int* py = pix + i * taps;
          const float* wy = wts + i * taps;
          float a[V];
#pragma unroll
          for (int e = 0; e < V; ++e) a[e] = 0.f;
          if (r0 > y_lo) fma_f32<V>(tp + (size_t)i * chunk * tc, 1.f, a);
#pragma unroll
          for (int k = 0; k < taps; ++k) {  // the same taps in every thread
            const int yo = py[k] - r0;
            if (wy[k] != 0.f && (unsigned)yo < (unsigned)rh)
              fma_vec<T, V>(col + (size_t)yo * chunk * tc, wy[k], a);
          }
          put_f32<V>(tp + (size_t)i * chunk * tc, a);
        }
      }
    }
    __syncthreads();
    // column pass: this thread's bins grp + s * (threads / tile)
    if (cv < tv) {
#pragma unroll
      for (int s = 0; s < kFwdOwn; ++s) {
        const int bin = grp + (s << (kFwdThreadsLog2 - lt));
        if (bin < R * R) {  // j-major: neighbouring groups share bin j
          const int j = bin / R, i = bin - j * R;
          const int* px = pix + (R + j) * taps;
          const float* wx = wts + (R + j) * taps;
          const float* row = tbuf + (size_t)i * chunk * tc + cv * V;
#pragma unroll
          for (int k = 0; k < taps; ++k) {
            const int xo = px[k] - c0;
            if (wx[k] != 0.f && (unsigned)xo < (unsigned)cw)
              fma_f32<V>(row + (size_t)xo * tc, wx[k], acc[s]);
          }
        }
      }
    }
  }
  if (cv < tv) {
    T* ob = out + (size_t)bo * R * R * C + (size_t)(v0 + cv) * V;
#pragma unroll
    for (int s = 0; s < kFwdOwn; ++s) {
      const int bin = grp + (s << (kFwdThreadsLog2 - lt));
      if (bin < R * R) {
        const int j = bin / R, i = bin - j * R;
        store_vec<T, V>(ob + (size_t)(i * R + j) * C, acc[s]);
      }
    }
  }
}

// K3's dynamic shared memory: the staged g (group, R, R, tile * V) in the
// I/O dtype; A_y over the band (O, R, band) and A_x over the columns
// (O, R, cols) in fp32; per box the rows [lo, hi) of g that meet the block
// (O, 2 ints); per box and bin the band rows it weighs (O, R bit masks);
// per box and column the bins [lo, hi) with a nonzero weight (O, cols, 2
// shorts).
size_t bwd_smem_bytes(int O, int R, int band, int cols, int group,
                      int tile_channels, int itemsize) {
  return align16((size_t)group * R * R * tile_channels * itemsize) +
         4 * ((size_t)O * R * (band + cols) + 2 * (size_t)O +
              (size_t)O * R + (size_t)O * cols);
}

template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, 2)
    roi_bwd_kernel(const T* __restrict__ g, const float* __restrict__ boxes,
                   T* __restrict__ df, int H, int W, int C, int O, int R,
                   int q, int tile, int band, int cols, int group) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int tc = tile * V;
  T* gs = reinterpret_cast<T*>(base);  // (group, R, R, tc)
  float* ay = reinterpret_cast<float*>(
      base + align16((size_t)group * R * R * tc * sizeof(T)));  // (O,R,band)
  float* ax = ay + (size_t)O * R * band;                        // (O,R,cols)
  int* rows = reinterpret_cast<int*>(ax + (size_t)O * R * cols);  // (O, 2)
  unsigned* masks = reinterpret_cast<unsigned*>(rows + 2 * O);    // (O, R)
  unsigned short* bins =
      reinterpret_cast<unsigned short*>(masks + O * R);  // (O, cols, 2)
  const int nvec = C / V, v0 = blockIdx.x * tile;
  const int tv = min(tile, nvec - v0);
  const int ncb = (W + cols - 1) / cols;
  const int y0 = (int)(blockIdx.y / ncb) * band;
  const int x0 = (int)(blockIdx.y % ncb) * cols;
  const int bh = min(band, H - y0), cw = min(cols, W - x0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* gb = g + (size_t)b * O * R * R * C + (size_t)v0 * V;

  // A warp copies rows [rows[2o], rows[2o+1]) of box o's g into `slot`.
  auto stage_box = [&](int o, int slot) {
    const int lo = rows[2 * o], n = (rows[2 * o + 1] - lo) * R * tv;
    const T* src = gb + (size_t)(o * R + lo) * R * C;
    T* dst = gs + ((size_t)slot * R + lo) * R * tc;
    for (int it = lane; it < n; it += 32) {
      const int cv = it % tv, ij = it / tv;
      stage<T, V>(dst + (size_t)ij * tc + cv * V,
                  src + (size_t)ij * C + (size_t)cv * V);
    }
  };

  // The tables, every thread at once: A_y over the band and A_x over the
  // columns (a thread per box, axis and bin adds its samples' weights in
  // order), then per bin the band rows it weighs and per column its bins.
  // The (origin, extent) of a thread's first bin is read before the
  // zeroing, so that the load's latency overlaps it.
  const float* bb = boxes + (size_t)b * O * 4;  // (x0, y0, w, h) per box
  float org = 0.f, ext = 0.f;
  if (threadIdx.x < 2 * O * R) {
    const int o = threadIdx.x / (2 * R), axis = threadIdx.x / R % 2;
    org = bb[o * 4 + (axis ? 0 : 1)];
    ext = bb[o * 4 + (axis ? 2 : 3)];
  }
  const int n_tab = O * R * (band + cols);
  for (int e = threadIdx.x; e < n_tab; e += kBwdThreads) ay[e] = 0.f;
  __syncthreads();
  {
    const float inv_q = 1.f / (float)q;
    for (int t = threadIdx.x; t < 2 * O * R; t += kBwdThreads) {
      const int o = t / (2 * R), axis = t / R % 2, i = t % R;
      if (t != threadIdx.x) {
        org = bb[o * 4 + (axis ? 0 : 1)];
        ext = bb[o * 4 + (axis ? 2 : 3)];
      }
      const int p0 = axis ? x0 : y0, len = axis ? cols : band;
      float* a = axis ? ax + ((size_t)o * R + i) * cols
                      : ay + ((size_t)o * R + i) * band;
      for (int k = 0; k < q; ++k) {
        int l;
        float w_lo, w_hi;
        axis_sample(org, ext, axis ? W : H, R * q, i * q + k, inv_q, &l,
                    &w_lo, &w_hi);
        if ((unsigned)(l - p0) < (unsigned)len) a[l - p0] += w_lo;
        if ((unsigned)(l + 1 - p0) < (unsigned)len) a[l + 1 - p0] += w_hi;
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < O * (R + cols); t += kBwdThreads) {
    if (t < O * R) {
      const float* a = ay + (size_t)t * band;
      unsigned m = 0;
      for (int p = 0; p < bh; ++p) m |= (a[p] != 0.f ? 1u : 0u) << p;
      masks[t] = m;
    } else {
      const int o = (t - O * R) / cols, x = (t - O * R) % cols;
      const float* a = ax + (size_t)o * R * cols + x;
      int lo = R, hi = 0;
      if (x < cw)
        for (int j = 0; j < R; ++j)
          if (a[j * cols] != 0.f) {
            lo = min(lo, j);
            hi = j + 1;
          }
      bins[2 * (o * cols + x)] = (unsigned short)lo;
      bins[2 * (o * cols + x) + 1] = (unsigned short)hi;
    }
  }
  __syncthreads();
  // A warp per box: the rows of g that meet the block (R, cols <= 32),
  // then the copy of those rows for the first group.
  for (int o = warp; o < O; o += kWarps) {
    const unsigned meet =
        __ballot_sync(0xffffffffu, lane < R && masks[o * R + lane] != 0u);
    const unsigned touched = __ballot_sync(
        0xffffffffu, lane < cols && bins[2 * (o * cols + lane) + 1] >
                                        bins[2 * (o * cols + lane)]);
    const bool hit = meet != 0u && touched != 0u;
    if (lane == 0) {
      rows[2 * o] = hit ? __ffs(meet) - 1 : 0;
      rows[2 * o + 1] = hit ? 32 - __clz(meet) : 0;
    }
    __syncwarp();
    if (o < group) stage_box(o, o);
  }

  // The df vectors this thread owns: one (column xx, channel vector cv) of
  // the block, at rows yy = r0 + s * rstep, s < kBwdOwn.
  const int pw = cw * tv;
  const int rstep = kBwdThreads / pw;
  const int pos = threadIdx.x % pw, r0 = threadIdx.x / pw;
  const int cv = pos % tv, xx = pos / tv;
  const bool owner = r0 < rstep;
  float acc[kBwdOwn][V];
#pragma unroll
  for (int s = 0; s < kBwdOwn; ++s)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[s][e] = 0.f;

  for (int o0 = 0; o0 < O; o0 += group) {
    const int o1 = min(O, o0 + group);
    if (o0 > 0) {
      __syncthreads();  // every thread is done with the previous group
      for (int o = warp; o < O; o += kWarps)  // the warp that found box o
        if (o >= o0 && o < o1) stage_box(o, o - o0);
    }
    stage_wait();
    __syncthreads();
    for (int o = o0; o < o1; ++o) {
      const int i_hi = rows[2 * o + 1];
      const int j0 = bins[2 * (o * cols + xx)];
      const int j1 = bins[2 * (o * cols + xx) + 1];
      if (!owner || j1 <= j0) continue;  // box o misses these outputs
      const float* ayo = ay + (size_t)o * R * band + r0;
      const float* axo = ax + (size_t)o * R * cols + xx;
      const T* go = gs + (size_t)(o - o0) * R * R * tc + cv * V;
      for (int i = rows[2 * o]; i < i_hi; ++i) {
        const unsigned m = masks[o * R + i] >> r0;  // rows this bin weighs
        if (m == 0u) continue;
        // sum_j A_x[j, xx] g[o, i, j, :], then spread over the rows by A_y
        float inner[V];
#pragma unroll
        for (int e = 0; e < V; ++e) inner[e] = 0.f;
        for (int j = j0; j < j1; ++j)
          fma_vec<T, V>(go + (i * R + j) * tc, axo[j * cols], inner);
#pragma unroll
        for (int s = 0; s < kBwdOwn; ++s)
          if ((m >> (s * rstep)) & 1u) {
            const float w = ayo[i * band + s * rstep];
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[s][e] = fmaf(w, inner[e], acc[s][e]);
          }
      }
    }
  }
  if (owner) {
    T* out = df + (((size_t)b * H + y0 + r0) * W + x0 + xx) * C +
             (size_t)(v0 + cv) * V;
#pragma unroll
    for (int s = 0; s < kBwdOwn; ++s)
      if (r0 + s * rstep < bh)
        store_vec<T, V>(out + (size_t)s * rstep * W * C, acc[s]);
  }
}

// q == 2, the sampling ratio the models use, has its own instance: its
// taps are built in registers (bin_taps_q), ~1.3 us faster per call at
// the train step than bin_taps on an H100.
const void* fwd_kernel_for(int dtype, int vec, int q) {
  const bool q2 = q == 2;
  if (dtype == 0 && vec == 4)
    return q2 ? (const void*)roi_fwd_kernel<float, 4, 2>
              : (const void*)roi_fwd_kernel<float, 4, 0>;
  if (dtype == 0 && vec == 1)
    return q2 ? (const void*)roi_fwd_kernel<float, 1, 2>
              : (const void*)roi_fwd_kernel<float, 1, 0>;
  if (dtype == 1 && vec == 8)
    return q2 ? (const void*)roi_fwd_kernel<__nv_bfloat16, 8, 2>
              : (const void*)roi_fwd_kernel<__nv_bfloat16, 8, 0>;
  if (dtype == 1 && vec == 1)
    return q2 ? (const void*)roi_fwd_kernel<__nv_bfloat16, 1, 2>
              : (const void*)roi_fwd_kernel<__nv_bfloat16, 1, 0>;
  return nullptr;
}

const void* bwd_kernel_for(int dtype, int vec) {
  if (dtype == 0 && vec == 4) return (const void*)roi_bwd_kernel<float, 4>;
  if (dtype == 0 && vec == 1) return (const void*)roi_bwd_kernel<float, 1>;
  if (dtype == 1 && vec == 8)
    return (const void*)roi_bwd_kernel<__nv_bfloat16, 8>;
  if (dtype == 1 && vec == 1)
    return (const void*)roi_bwd_kernel<__nv_bfloat16, 1>;
  return nullptr;
}

cudaError_t launch(const void* k, dim3 grid, int threads, int smem,
                   void** args, void* stream) {
  cudaError_t err = cudaLaunchKernel(k, grid, dim3(threads), args,
                                     (size_t)smem,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // not sticky: clear it
  return err;
}

bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

extern "C" {

// Lets every kernel instance take up to the card's opt-in shared memory on
// the current device. Call once per device before the first launch.
int objgan_roi_align_setup() {
  const int vecs[] = {4, 1, 8, 1};
  for (int d = 0; d < 4; ++d) {
    const void* ks[] = {fwd_kernel_for(d / 2, vecs[d], 2),
                        fwd_kernel_for(d / 2, vecs[d], 0),
                        bwd_kernel_for(d / 2, vecs[d])};
    for (const void* k : ks) {
      cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
      }
    }
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; vec: 16 / itemsize or 1. features
// (B, H, W, C) and out (B, O, R, R, C) contiguous in that dtype; boxes
// (B, O, 4) fp32 normalised (x0, y0, w, h); q = sampling ratio. The plan
// (ops/roi_align.py::fwd_plan): `tile` vectors of channels per block, the
// box's footprint in patches of `rows` rows by `chunk` columns, `smem`
// bytes of dynamic shared memory. Returns 0 when launched,
// cudaErrorInvalidValue (1) for a plan this file does not take, else the
// launch's error.
int objgan_roi_align_fwd(const void* features, const void* boxes, void* out,
                         int dtype, int B, int H, int W, int C, int O, int R,
                         int q, int vec, int tile, int rows, int chunk,
                         int smem, void* stream) {
  const void* k = fwd_kernel_for(dtype, vec, q);
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool ok =
      k && B >= 1 && O >= 1 && (long long)B * O <= 0x7fffffff && H >= 1 &&
      W >= 1 && C >= 1 && R >= 1 && q >= 1 && C % vec == 0 && tile >= 1 &&
      tile <= C / vec && (tile & (tile - 1)) == 0 &&
      (long long)R * R * tile <= kFwdThreads * kFwdOwn && rows >= 1 &&
      rows <= H && chunk >= 1 && chunk <= W && chunk * tile <= kFwdThreads &&
      smem <= kMaxSmem &&
      fwd_smem_bytes(R, q, rows, chunk, tile * vec, itemsize) <=
          (size_t)smem &&
      (vec == 1 || aligned16(features, out));
  if (!ok) return (int)cudaErrorInvalidValue;
  void* args[] = {const_cast<void**>(&features), const_cast<void**>(&boxes),
                  &out, &H, &W, &C, &O, &R, &q, &tile, &rows, &chunk};
  const int tiles = (C / vec + tile - 1) / tile;
  return (int)launch(k, dim3(B * O, tiles), kFwdThreads, smem, args, stream);
}

// g (B, O, R, R, C) and df (B, H, W, C) contiguous in dtype; boxes as above.
// The plan (ops/roi_align.py::bwd_plan): blocks of `band` (<= 32) df rows,
// `cols` (<= 32) columns and `tile` vectors of channels, g staged `group`
// boxes at a time, `smem` bytes of dynamic shared memory; R <= 32. Returns
// as above.
int objgan_roi_align_bwd(const void* g, const void* boxes, void* df,
                         int dtype, int B, int H, int W, int C, int O, int R,
                         int q, int vec, int tile, int band, int cols,
                         int group, int smem, void* stream) {
  const void* k = bwd_kernel_for(dtype, vec);
  const int itemsize = dtype == 0 ? 4 : 2;
  const long long blocks_yx =
      band >= 1 && cols >= 1
          ? (long long)((H + band - 1) / band) * ((W + cols - 1) / cols)
          : 0;
  const bool ok =
      k && B >= 1 && B <= 65535 && O >= 1 && H >= 1 && W >= 1 && C >= 1 &&
      R >= 1 && R <= 32 && q >= 1 && C % vec == 0 && tile >= 1 &&
      tile <= C / vec && band >= 1 && band <= H && band <= 32 &&
      cols >= 1 && cols <= W && cols <= 32 &&
      (long long)cols * tile <= kBwdThreads &&
      band <= kBwdThreads / (cols * tile) * kBwdOwn && group >= 1 &&
      group <= O && blocks_yx <= 65535 && smem <= kMaxSmem &&
      bwd_smem_bytes(O, R, band, cols, group, tile * vec, itemsize) <=
          (size_t)smem &&
      (vec == 1 || aligned16(g, df));
  if (!ok) return (int)cudaErrorInvalidValue;
  void* args[] = {const_cast<void**>(&g), const_cast<void**>(&boxes), &df,
                  &H, &W, &C, &O, &R, &q, &tile, &band, &cols, &group};
  const int tiles = (C / vec + tile - 1) / tile;
  return (int)launch(k, dim3(tiles, (unsigned)blocks_yx, B), kBwdThreads,
                     smem, args, stream);
}

}  // extern "C"
