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
// Bound: device-memory bytes. Per output element K2 does 4q^2 multiply-adds
// (16 at q = 2) on values that sit in L2, so the time is the feature reads
// and the output write; K3 likewise reads the cotangent and writes df once.
//
// K2: one block per (b, o, row i of bins), so that B*O*R blocks (1120 at
//     the train step's shape) keep enough loads in flight. The block first
//     tabulates, per axis, each sample's low pixel and its two weights
//     (the 1/q average folded in) in shared memory; then threads stride
//     over (bin j, 16-byte channel vector), neighbouring threads on
//     neighbouring channels, and sum the q*q samples x 4 corners in fp32
//     before one rounded store.
// K3: one block per (b, row y) of df, so no two blocks write the same
//     element and no atomics are needed. The block builds A_x (O, R, W)
//     for every object and row y's column of A_y (O, R) in shared memory,
//     then lists the (o, i) with A_y[i,y] != 0 and, per (o, x), the
//     contiguous range of bins j with A_x[j,x] != 0. Each thread owns one
//     (x, channel vector) of the row and sums A_y[i,y] * A_x[j,x] *
//     g[o,i,j,:] over those terms only, in a fixed order (o, i, j
//     ascending) in fp32, then rounds once. The result is bit-reproducible
//     run to run.
// The TPU kernels ran two dense matmuls per (b, o) through the MXU; here the
// bilinear weights are local (at most 2q nonzero pixels per bin and axis),
// so both kernels touch only the pixels the samples need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_fwd_kernel(const T* __restrict__ f, const float* __restrict__ boxes,
                   T* __restrict__ out, int H, int W, int C, int O, int R,
                   int q) {
  extern __shared__ float smem[];  // per axis (y, x): w_lo, w_hi, lo
  const int RQ = R * q;
  float* wl = smem;
  float* wh = smem + 2 * RQ;
  int* lo = reinterpret_cast<int*>(smem + 4 * RQ);
  const int bo = blockIdx.x / R, i = blockIdx.x % R;
  const int b = bo / O;
  const float* box = boxes + (size_t)bo * 4;  // (x0, y0, w, h)
  const float inv_q = 1.f / (float)q;
  for (int t = threadIdx.x; t < 2 * RQ; t += blockDim.x) {
    const int axis = t / RQ, idx = t % RQ;  // axis 0 = y, 1 = x
    axis_sample(axis == 0 ? box[1] : box[0], axis == 0 ? box[3] : box[2],
                axis == 0 ? H : W, RQ, idx, inv_q, &lo[t], &wl[t], &wh[t]);
  }
  __syncthreads();

  const int nvec = C / V;
  const T* fb = f + (size_t)b * H * W * C;
  T* ob = out + (size_t)bo * R * R * C;
  for (int it = threadIdx.x; it < R * nvec; it += blockDim.x) {
    const int cv = it % nvec, j = it / nvec;
    const int bin = i * R + j;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int ky = 0; ky < q; ++ky) {
      const int sy = i * q + ky;
      const int y0 = lo[sy];
      const float wy[2] = {wl[sy], wh[sy]};
      for (int kx = 0; kx < q; ++kx) {
        const int sx = RQ + j * q + kx;
        const int x0 = lo[sx];
        const float wx[2] = {wl[sx], wh[sx]};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float w = wy[dy] * wx[dx];
            if (w != 0.f)
              fma_vec<T, V>(fb + ((size_t)(y0 + dy) * W + (x0 + dx)) * C +
                                (size_t)cv * V,
                            w, acc);
          }
        }
      }
    }
    store_vec<T, V>(ob + (size_t)bin * C + (size_t)cv * V, acc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_bwd_kernel(const T* __restrict__ g, const float* __restrict__ boxes,
                   T* __restrict__ df, int H, int W, int C, int O, int R,
                   int q) {
  extern __shared__ float smem[];
  const int OR = O * R;
  float* ax = smem;             // (O, R, W): A_x of every object
  float* col = ax + OR * W;     // (O, R): column y of every A_y
  float* wy = col + OR;         // the nonzero entries of col, in order,
  int* term = reinterpret_cast<int*>(wy + OR);  // and their o * R + i
  int* jlo = term + OR;         // (O, W): the bins j with A_x[j, x] != 0
  int* jhi = jlo + O * W;       //   are jlo <= j < jhi (contiguous)
  __shared__ int n_terms;
  const int y = blockIdx.x, b = blockIdx.y;
  const int RQ = R * q;
  const float inv_q = 1.f / (float)q;
  const float* bb = boxes + (size_t)b * O * 4;
  for (int t = threadIdx.x; t < OR * W; t += blockDim.x) ax[t] = 0.f;
  __syncthreads();
  for (int t = threadIdx.x; t < OR; t += blockDim.x) {
    const int r = t % R;
    const float* box = bb + (t / R) * 4;
    float* row = ax + (size_t)t * W;
    float c = 0.f;
    for (int k = 0; k < q; ++k) {
      int l;
      float w_lo, w_hi;
      axis_sample(box[0], box[2], W, RQ, r * q + k, inv_q, &l, &w_lo, &w_hi);
      row[l] += w_lo;
      if (l + 1 < W) row[l + 1] += w_hi;
      axis_sample(box[1], box[3], H, RQ, r * q + k, inv_q, &l, &w_lo, &w_hi);
      if (l == y) c += w_lo;
      if (l + 1 == y) c += w_hi;
    }
    col[t] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // compact the (o, i) terms that touch row y
    int n = 0;
    for (int t = 0; t < OR; ++t)
      if (col[t] != 0.f) {
        wy[n] = col[t];
        term[n++] = t;
      }
    n_terms = n;
  }
  for (int t = threadIdx.x; t < O * W; t += blockDim.x) {
    const int o = t / W, x = t % W;
    int lo = R, hi = 0;
    for (int j = 0; j < R; ++j)
      if (ax[(o * R + j) * W + x] != 0.f) {
        lo = min(lo, j);
        hi = j + 1;
      }
    jlo[t] = lo;
    jhi[t] = hi;
  }
  __syncthreads();

  const int nvec = C / V;
  const T* gb = g + (size_t)b * OR * R * C;
  T* drow = df + ((size_t)b * H + y) * W * C;
  for (int it = threadIdx.x; it < W * nvec; it += blockDim.x) {
    const int cv = it % nvec, x = it / nvec;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int k = 0; k < n_terms; ++k) {  // o, then i, ascending
      const int oi = term[k], o = oi / R;
      const float w_y = wy[k];
      const int hi = jhi[o * W + x];
      for (int j = jlo[o * W + x]; j < hi; ++j)
        fma_vec<T, V>(gb + ((size_t)oi * R + j) * C + (size_t)cv * V,
                      w_y * ax[(o * R + j) * W + x], acc);
    }
    store_vec<T, V>(drow + (size_t)x * C + (size_t)cv * V, acc);
  }
}

// K3's dynamic shared memory: A_x (O, R, W), A_y's column y, its compacted
// nonzero entries and their indices (3 x (O, R)), the j ranges (2 x (O, W)).
size_t bwd_smem_bytes(int O, int R, int W) {
  return sizeof(float) * ((size_t)O * R * (W + 3) + 2 * (size_t)O * W);
}

// Dynamic shared memory a launch may take without an opt-in attribute.
constexpr size_t kMaxDynamicSmem = 48 * 1024;

template <typename T, int V>
cudaError_t launch(bool forward, const void* in, const float* boxes,
                   void* out, int B, int H, int W, int C, int O, int R, int q,
                   cudaStream_t stream) {
  const T* it = static_cast<const T*>(in);
  T* ot = static_cast<T*>(out);
  if (forward) {
    roi_fwd_kernel<T, V><<<B * O * R, kThreads, 6 * R * q * sizeof(float),
                           stream>>>(it, boxes, ot, H, W, C, O, R, q);
  } else {
    const size_t smem = bwd_smem_bytes(O, R, W);
    if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
    roi_bwd_kernel<T, V><<<dim3(H, B), kThreads, smem, stream>>>(
        it, boxes, ot, H, W, C, O, R, q);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(bool forward, const void* in, const float* boxes,
                         void* out, int B, int H, int W, int C, int O, int R,
                         int q, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte accesses need C to split into vectors and both bases aligned
  const bool vec_ok = C % kVec == 0 && (uintptr_t)in % 16 == 0 &&
                      (uintptr_t)out % 16 == 0;
  if (vec_ok)
    return launch<T, kVec>(forward, in, boxes, out, B, H, W, C, O, R, q,
                           stream);
  return launch<T, 1>(forward, in, boxes, out, B, H, W, C, O, R, q, stream);
}

cudaError_t dispatch(bool forward, const void* in, const void* boxes,
                     void* out, int dtype, int B, int H, int W, int C, int O,
                     int R, int q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0)
    return dispatch_vec<float>(forward, in, bx, out, B, H, W, C, O, R, q, st);
  if (dtype == 1)
    return dispatch_vec<__nv_bfloat16>(forward, in, bx, out, B, H, W, C, O, R,
                                       q, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. features (B, H, W, C) and out
// (B, O, R, R, C) contiguous in that dtype; boxes (B, O, 4) fp32 normalised
// (x0, y0, w, h); q = sampling ratio. Returns cudaGetLastError().
int objgan_roi_align_fwd(const void* features, const void* boxes, void* out,
                         int dtype, int B, int H, int W, int C, int O, int R,
                         int q, void* stream) {
  return (int)dispatch(true, features, boxes, out, dtype, B, H, W, C, O, R, q,
                       stream);
}

// g (B, O, R, R, C) and df (B, H, W, C) contiguous in dtype; boxes as above.
// Returns cudaErrorInvalidValue, launching nothing, when O, R and W need
// more than 48 KiB of shared memory (bwd_smem_bytes).
int objgan_roi_align_bwd(const void* g, const void* boxes, void* df,
                         int dtype, int B, int H, int W, int C, int O, int R,
                         int q, void* stream) {
  return (int)dispatch(false, g, boxes, df, dtype, B, H, W, C, O, R, q,
                       stream);
}

}  // extern "C"
