// GroupNorm (+ optional GLU epilogue) over channels-last activations, for
// sm_90a. Kernel K1 of the port.
//
// Replaces objgan_tpu/ops/groupnorm.py::_kernel (the Pallas TPU kernel that
// _pallas_group_norm launches). Same semantics as that kernel and as
// objgan_tpu_torch/ops/groupnorm.py::group_norm_reference:
//   per (batch, group): mean = E[x], var = max(E[x^2] - E[x]^2, 0) in fp32,
//   inv = rsqrt(var + eps); per channel a_c = inv * scale_c,
//   b_c = bias_c - mean * a_c; y = x * a_c + b_c rounded to the I/O dtype.
//   With GLU, out[:, j] = y[:, j] * sigmoid(y[:, j + C/2]), the gate computed
//   in fp32 and rounded at the reference's points (after the affine, after
//   the sigmoid, after the product).
//
// Bound: device-memory bytes. The arithmetic is a few flops per element, so
// the time is the traffic: one read of x for the statistics, then one read of
// x and one write of y for the apply pass (1R for stats + 1R/1W for apply).
// The TPU kernel kept x resident in VMEM to read it once; an SM has no room
// for a (N, C) slice, so this design takes the second read and spends its
// effort on spreading the statistics over every SM instead:
//   1. stats:    grid (S, B). Each block sums a contiguous range of rows of
//                x[b] per channel, threads striding over channels with
//                16-byte vector loads along contiguous C, and writes fp32
//                partials to a (B, S, C) scratch. No atomics: the reduction
//                order is fixed, so the output is bit-reproducible run to run.
//   2. finalize: grid (B). Sums the S partials per channel, then the
//                channels of each group, and writes (a_c, b_c) per channel.
//   3. apply:    grid-stride loop over 16-byte vectors of the output.
// Reading x once (keeping the slice in shared memory across a cluster) is
// left to a later change.

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

// round an fp32 value to T and back: the reference's rounding points
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f32(pk.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int j = 0; j < V; ++j) pk.v[j] = from_f32<T>(in[j]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// Partial per-channel sums of rows [s*rows_per_split, (s+1)*rows_per_split)
// of x[b] into psum/psq[(b*S + s)*C + c].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ psum,
                    float* __restrict__ psq, int N, int C,
                    int rows_per_split) {
  extern __shared__ float smem[];  // 2 * kThreads * V floats
  float* ssum = smem;
  float* ssq = smem + kThreads * V;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int nvec = C / V;
  const int tpr = nvec < kThreads ? nvec : kThreads;  // threads along a row
  const int rpi = kThreads / tpr;                       // rows per iteration
  const int tx = threadIdx.x % tpr, ty = threadIdx.x / tpr;
  const int r0 = s * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const T* xb = x + (size_t)b * N * C;
  const int width = tpr * V;  // channels covered by one column chunk

  for (int v0 = 0; v0 < nvec; v0 += tpr) {
    float acc[V], acc2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
    const int v = v0 + tx;
    if (ty < rpi && v < nvec) {
      for (int r = r0 + ty; r < r1; r += rpi) {
        float e[V];
        load_vec<T, V>(xb + (size_t)r * C + (size_t)v * V, e);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j] += e[j];
          acc2[j] = fmaf(e[j], e[j], acc2[j]);
        }
      }
    }
    // smem[ty][tx*V + j]
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ssum[threadIdx.x * V + j] = acc[j];
      ssq[threadIdx.x * V + j] = acc2[j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < width; i += kThreads) {
      const int c = v0 * V + i;
      if (c < C) {
        float a = 0.f, a2 = 0.f;
        for (int y = 0; y < rpi; ++y) {
          a += ssum[y * width + i];
          a2 += ssq[y * width + i];
        }
        const size_t o = ((size_t)b * S + s) * C + c;
        psum[o] = a;
        psq[o] = a2;
      }
    }
    __syncthreads();
  }
}

// Per batch element: group statistics and the per-channel affine
// coef[b, 0, c] = a_c, coef[b, 1, c] = b_c.
__global__ void __launch_bounds__(kThreads)
    gn_finalize_kernel(const float* __restrict__ psum,
                       const float* __restrict__ psq,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       float* __restrict__ coef, int S, int C, int G,
                       float count, float eps) {
  extern __shared__ float sm[];  // (2C + 2G) floats
  float* csum = sm;
  float* csq = sm + C;
  float* gmean = sm + 2 * C;
  float* ginv = gmean + G;
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t o = ((size_t)b * S + s) * C + c;
      a += psum[o];
      a2 += psq[o];
    }
    csum[c] = a;
    csq[c] = a2;
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      a += csum[g * cg + k];
      a2 += csq[g * cg + k];
    }
    const float mean = a / count;
    const float var = fmaxf(a2 / count - mean * mean, 0.f);
    gmean[g] = mean;
    ginv[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  float* ab = coef + (size_t)b * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float a = ginv[g] * scale[c];
    ab[c] = a;
    ab[C + c] = bias[c] - gmean[g] * a;
  }
}

// y = x * a_c + b_c (or its GLU) over every 16-byte output vector.
template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ coef, long long total_vec,
                    int N, int C) {
  const int c_out = GLU ? C / 2 : C;
  const int nvec_out = c_out / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total_vec; i += stride) {
    const int c0 = (int)(i % nvec_out) * V;
    const long long row = i / nvec_out;  // b * N + n
    const int b = (int)(row / N);
    const float* a_c = coef + (size_t)b * 2 * C;
    const float* b_c = a_c + C;
    const T* xr = x + row * C;
    float e[V], out[V];
    load_vec<T, V>(xr + c0, e);
    if (!GLU) {
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = e[j] * a_c[c0 + j] + b_c[c0 + j];
    } else {
      float g[V];
      load_vec<T, V>(xr + c_out + c0, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ca = c0 + j, cgate = c_out + c0 + j;
        const float av = round_to<T>(e[j] * a_c[ca] + b_c[ca]);
        const float gv = round_to<T>(g[j] * a_c[cgate] + b_c[cgate]);
        const float sig = round_to<T>(1.f / (1.f + expf(-gv)));
        out[j] = av * sig;  // rounded by the store
      }
    }
    store_vec<T, V>(y + row * c_out + c0, out);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, void* y, const float* scale,
                   const float* bias, float* psum, float* psq, float* coef,
                   int B, int N, int C, int G, int S, float eps, int use_glu,
                   int apply_blocks, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int rows_per_split = (N + S - 1) / S;
  gn_stats_kernel<T, V>
      <<<dim3(S, B), kThreads, 2 * kThreads * V * sizeof(float), stream>>>(
          xt, psum, psq, N, C, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float count = (float)N * (float)(C / G);
  gn_finalize_kernel<<<B, kThreads, (2 * C + 2 * G) * sizeof(float),
                       stream>>>(psum, psq, scale, bias, coef, S, C, G, count,
                                 eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total_vec =
      (long long)B * N * (use_glu ? C / 2 : C) / V;
  if (use_glu)
    gn_apply_kernel<T, V, true><<<apply_blocks, kThreads, 0, stream>>>(
        xt, yt, coef, total_vec, N, C);
  else
    gn_apply_kernel<T, V, false><<<apply_blocks, kThreads, 0, stream>>>(
        xt, yt, coef, total_vec, N, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(const void* x, void* y, const float* scale,
                         const float* bias, float* psum, float* psq,
                         float* coef, int B, int N, int C, int G, int S,
                         float eps, int use_glu, int apply_blocks,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads need every row start, and with GLU the gate half's start,
  // on a 16-byte boundary
  const bool vec_ok = C % kVec == 0 && (!use_glu || (C / 2) % kVec == 0);
  if (vec_ok)
    return launch<T, kVec>(x, y, scale, bias, psum, psq, coef, B, N, C, G, S,
                           eps, use_glu, apply_blocks, stream);
  return launch<T, 1>(x, y, scale, bias, psum, psq, coef, B, N, C, G, S, eps,
                      use_glu, apply_blocks, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, N, C) contiguous; y (B, N, C) or
// (B, N, C/2) with use_glu; scale/bias (C,) fp32; psum/psq (B, S, C) fp32
// and coef (B, 2, C) fp32 scratch. Returns cudaGetLastError() (0 = launched).
int objgan_group_norm(const void* x, void* y, const void* scale,
                      const void* bias, void* psum, void* psq, void* coef,
                      int dtype, int B, int N, int C, int G, int S, float eps,
                      int use_glu, int apply_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  float* cf = static_cast<float*>(coef);
  if (dtype == 0)
    return (int)dispatch_vec<float>(x, y, sc, bi, ps, pq, cf, B, N, C, G, S,
                                    eps, use_glu, apply_blocks, st);
  if (dtype == 1)
    return (int)dispatch_vec<__nv_bfloat16>(x, y, sc, bi, ps, pq, cf, B, N, C,
                                            G, S, eps, use_glu, apply_blocks,
                                            st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
