// GroupNorm (+ optional GLU epilogue) over channels-last activations, for
// sm_90a. Kernel K1 of the port, and below it K1 backward, its gradients.
//
// Replaces objgan_tpu/ops/groupnorm.py::_kernel (the Pallas TPU kernel that
// _pallas_group_norm launches). Same semantics as that kernel and as
// objgan_tpu_torch/ops/groupnorm.py::group_norm_reference:
//   per (batch, group): mean = E[x], var = max(E[x^2] - E[x]^2, 0) in fp32,
//   taken about a pivot k (the group's first value in row 0): mean = k +
//   E[x - k], var = max(E[(x - k)^2] - E[x - k]^2, 0), the same in exact
//   arithmetic; in fp32 it spares the cancellation that E[x^2] - E[x]^2
//   suffers when |mean| >> std (E[x - k] is of the order of std);
//   inv = rsqrt(var + eps); per channel a_c = inv * scale_c,
//   b_c = bias_c - mean * a_c; y = x * a_c + b_c rounded to the I/O dtype.
//   With GLU, out[:, j] = y[:, j] * sigmoid(y[:, j + C/2]), the gate computed
//   in fp32 and rounded at the reference's points (after the affine, after
//   the sigmoid, after the product).
//
// Bound: device-memory bytes. The arithmetic is a few flops per element, so
// the least time is one read of x and one write of y. The TPU kernel reached
// it by holding a batch element's (N, C) slice in VMEM. This design does the
// same across a thread-block cluster: ONE launch, grid (cluster, B), one
// cluster per batch element, each CTA owning a contiguous row range of x[b].
//   1. The rows a CTA keeps ("resident") are copied into its shared memory,
//      by bulk async copies (cp.async.bulk) on up to kChunks mbarriers, so
//      the statistics start on the first chunk while the rest is in flight
//      (by the threads for small shares and for a vector width of 1).
//      Rows beyond those ("streaming") are read with 16-byte loads, or
//      through a ring of kStages bulk-copied slots for long streams.
//   2. Per-channel fp32 sums and sums of squares: threads stride over rows
//      with 16-byte vectors along C, then a fixed-order tree over the block.
//      The sums are taken about the pivot (above), and a thread sums the
//      kUnroll rows it holds before adding them to its running sums. (E[x^2]
//      - E[x]^2 of plain sums magnifies their error by 1 + mean^2 / var,
//      about 37 at the DAMSM step's (48, 16384, 32), which put fp32 calls
//      there near the tolerance K1 is held to.)
//   3. The cluster gathers every CTA's per-channel partials through
//      distributed shared memory behind barrier.cluster and sums them in
//      rank order: every CTA computes the same group statistics and
//      per-channel (a_c, b_c). No atomics, no global scratch: the output is
//      bit-reproducible run to run.
//   4. Apply (+GLU) and write y: streamed rows are read a second time
//      (through the ring they are marked evict-last in L2 on their first
//      read, and y evict-first), resident rows come from shared memory. x
//      is read from HBM once when the slice is resident.
// This replaces a three-launch design (stats, finalize, apply) that read x
// twice and passed partial sums through a (B, S, C) global scratch.
//
// The launch plan (regime, cluster size, rows per CTA, resident and ring
// rows, dynamic shared memory) is ops/groupnorm.py::_plan. What limits it on
// an H100: a cluster's phases (read, reduce, write) run in turn, so a call
// goes fastest when all of its clusters run in one wave, and the card
// co-schedules 16 clusters of 12 at two CTAs per SM but only 14 of 14 or 16
// (GPCs of 12 to 18 SMs). So a CTA keeps to half an SM's shared memory and
// a batch of 16 takes clusters of at most 12. On the served batch
// (cfg/eval_coco.yml) Stage B's (160, 64, 256) fp32 and Stage C's bf16
// calls up to (16, 4096, 96) are resident (clusters of 1 to 8), as is
// (160, 4096, 64) fp32 (clusters of 16, several waves); (160, 256|1024, ·)
// fp32 stream at cluster 1 and the bf16 calls from (16, 4096, 192) up at
// cluster 12, through the ring where a CTA streams more than 96 KB. On the
// train step the discriminators' bf16 calls are resident (clusters of 1 to
// 12) and the image encoder's fp32 (16, 16384, 32) streams at cluster 12.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kChunks = 8;          // mbarriers over the resident rows
constexpr int kStages = 4;          // ring slots for the streamed rows
constexpr int kPiece = 32768;       // bytes per bulk copy
constexpr int kMaxSmem = 232448;    // opt-in dynamic shared memory per block
constexpr int kUnroll = 4;          // rows in flight per thread

struct Params {
  const void* x;
  void* y;
  const float* scale;
  const float* bias;
  int N, C, G;
  int rows;       // rows per CTA (the last may have fewer)
  int res_rows;   // rows per CTA kept in shared memory
  int ring_rows;  // rows per ring slot for the rest; 0: 16-byte loads
  int bulk;       // copy the resident rows with bulk copies (else threads)
  float eps;
};

// Bytes of shared memory before the ring and the row tile: the mbarriers,
// a scratch of kThreads * V floats (the block reduction, then the cluster's
// partials gathered) and three 2C float arrays (this CTA's partials, the
// cluster's sums, the affine). ops/groupnorm.py's _fixed_smem computes the
// same number.
__host__ __device__ inline int tile_offset(int C, int V) {
  const int raw = (kChunks + kStages) * 8 + kThreads * V * 4 + 6 * C * 4;
  return (raw + 127) / 128 * 128;
}

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

// two fp32 values rounded to bf16 and back, as round_to<bf16> each
__device__ __forceinline__ float2 round_pair(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f32(pk.v[j]);
}

// `once` stores a 16-byte vector to global memory evict-first in L2
// (st.global.cs), so that it does not push out rows that are read again
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V],
                                          bool once = false) {
  Pack<T, V> pk;
#pragma unroll
  for (int j = 0; j < V; ++j) pk.v[j] = from_f32<T>(in[j]);
  if constexpr (sizeof(pk) == 16) {
    if (once) {
      __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&pk));
      return;
    }
  }
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// L2 eviction policies: rows read once go first, rows read again stay
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// global -> this CTA's shared memory, completion counted on bar, the lines
// kept in L2 by `policy`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// 1 / x to within an ulp (MUFU.RCP): the sigmoid is rounded to T after it
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Sums rows [0, nrows) of src (row stride C) at channels [v*V, v*V + V),
// less the pivots k, into acc / acc2: this thread takes rows ty, ty + rpi,
// ..., U rows in flight. With COPY each vector is also stored at the same
// place in dst.
template <typename T, int V, int U, bool COPY>
__device__ __forceinline__ void accumulate(const T* src, T* dst, int nrows,
                                           int C, int v, int ty, int rpi,
                                           const float (&k)[V],
                                           float (&acc)[V], float (&acc2)[V]) {
  for (int r = ty; r < nrows; r += U * rpi) {
    float e[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rpi;
      if (rr < nrows) {
        load_vec<T, V>(src + (size_t)rr * C + (size_t)v * V, e[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) e[u][j] = k[j];  // adds nothing
      }
    }
    if (COPY) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * rpi;
        if (rr < nrows) store_vec<T, V>(dst + (size_t)rr * C + (size_t)v * V,
                                        e[u]);
      }
    }
    // the U rows of this step summed first, then added to the running
    // sums: a thread's sequential chain is nrows / U long
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float d = e[u][j] - k[j];
        s += d;
        s2 = fmaf(d, d, s2);
      }
      acc[j] += s;
      acc2[j] += s2;
    }
  }
}

// y rows [0, nrows) from src rows [0, nrows) (row strides C and c_out) at
// output channels [c0, c0 + V): this thread takes rows oy, oy + rpo, ...
// `once`: store evict-first (store_vec).
template <typename T, int V, int U, bool GLU>
__device__ __forceinline__ void apply_rows(
    const T* src, T* dst, int nrows, int C, int c_out, int c0, int oy,
    int rpo, const float (&a)[V], const float (&bb)[V], const float (&ag)[V],
    const float (&bg)[V], bool once) {
  for (int r = oy; r < nrows; r += U * rpo) {
    float e[U][V], g[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rpo;
      if (rr < nrows) {
        load_vec<T, V>(src + (size_t)rr * C + c0, e[u]);
        if (GLU) load_vec<T, V>(src + (size_t)rr * C + c_out + c0, g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rpo;
      if (rr >= nrows) continue;
      float out[V];
      if constexpr (GLU && sizeof(T) == 2 && V % 2 == 0) {
        // bf16 pairs: one instruction rounds two values
#pragma unroll
        for (int j = 0; j < V; j += 2) {
          const float2 av = round_pair(fmaf(e[u][j], a[j], bb[j]),
                                       fmaf(e[u][j + 1], a[j + 1], bb[j + 1]));
          const float2 gv = round_pair(fmaf(g[u][j], ag[j], bg[j]),
                                       fmaf(g[u][j + 1], ag[j + 1], bg[j + 1]));
          const float2 sig = round_pair(rcp_approx(1.f + __expf(-gv.x)),
                                        rcp_approx(1.f + __expf(-gv.y)));
          out[j] = av.x * sig.x;  // rounded by the store
          out[j + 1] = av.y * sig.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (!GLU) {
            out[j] = e[u][j] * a[j] + bb[j];
          } else {
            const float av = round_to<T>(e[u][j] * a[j] + bb[j]);
            const float gv = round_to<T>(g[u][j] * ag[j] + bg[j]);
            const float sig = round_to<T>(rcp_approx(1.f + __expf(-gv)));
            out[j] = av * sig;  // rounded by the store
          }
        }
      }
      store_vec<T, V>(dst + (size_t)rr * c_out + c0, out, once);
    }
  }
}

// One cluster per batch element (blockIdx.y), one CTA per cluster rank.
template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2) gn_fused_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kApplyUnroll = GLU ? 2 : kUnroll;  // GLU: two rows' x, gate
  constexpr int kScratch = kThreads * V;           // floats
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int N = p.N, C = p.C;
  const int r0 = min(N, rank * p.rows);
  const int r1 = min(N, r0 + p.rows);
  const int nres = min(p.res_rows, r1 - r0);
  const int s0 = r0 + nres;  // first streamed row
  const bool bulk = V > 1 && p.bulk;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // resident chunks
  uint64_t* ring_bars = bars + kChunks;
  float* red = reinterpret_cast<float*>(smem + (kChunks + kStages) * 8);
  float* part = red + kScratch;  // this CTA's partials, read by the cluster
  float* tot = part + 2 * C;     // the cluster's sums
  float* coef = tot + 2 * C;     // scale and bias, then a_c and b_c
  T* ring = reinterpret_cast<T*>(smem + tile_offset(C, V));
  T* tile = ring + (size_t)kStages * p.ring_rows * C;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * N * C;

  // the streamed rows go through the ring twice (statistics, then apply):
  // ring chunk j < 2 * nring covers rows s0 + (j % nring) * ring_rows, ...
  const int nring =
      V > 1 && p.ring_rows ? (r1 - s0 + p.ring_rows - 1) / p.ring_rows : 0;
  auto ring_len = [&](int j) {
    return min(p.ring_rows, r1 - s0 - (j % nring) * p.ring_rows);
  };
  auto ring_slot = [&](int j) {
    return ring + (size_t)(j % kStages) * p.ring_rows * C;
  };
  auto fetch_ring = [&](int j) {  // one thread; kept in L2 for the apply
    const uint32_t bytes = (uint32_t)ring_len(j) * C * sizeof(T);
    mbar_expect_tx(&ring_bars[j % kStages], bytes);
    bulk_copy(ring_slot(j), xb + (size_t)(s0 + (j % nring) * p.ring_rows) * C,
              bytes, &ring_bars[j % kStages],
              j < nring ? l2_evict_last() : l2_evict_first());
  };
  auto wait_ring = [&](int j) {
    mbar_wait(&ring_bars[j % kStages], (j / kStages) & 1);
  };

  // 1. queue the first ring chunks and every resident row's copy up front
  const int chunk_rows = (nres + kChunks - 1) / kChunks;
  const int nchunks = chunk_rows ? (nres + chunk_rows - 1) / chunk_rows : 0;
  if (V > 1 && threadIdx.x == 0) {
    for (int k = 0; k < kChunks + kStages; ++k) mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (V > 1 && threadIdx.x == 0) {
    for (int j = 0; j < min(kStages, 2 * nring); ++j) fetch_ring(j);
    for (int k = 0; bulk && k < nchunks; ++k) {
      const int rows_k = min(chunk_rows, nres - k * chunk_rows);
      const uint32_t bytes = (uint32_t)rows_k * C * sizeof(T);
      const char* src = reinterpret_cast<const char*>(
          xb + (size_t)(r0 + k * chunk_rows) * C);
      char* dst = reinterpret_cast<char*>(tile + (size_t)k * chunk_rows * C);
      mbar_expect_tx(&bars[k], bytes);
      for (uint32_t off = 0; off < bytes; off += kPiece)
        bulk_copy(dst + off, src + off, min((uint32_t)kPiece, bytes - off),
                  &bars[k], l2_evict_first());
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {  // while the rows land
    coef[c] = p.scale[c];
    coef[C + c] = p.bias[c];
  }

  // 2. per-channel partial sums of this CTA's rows, about the pivot of the
  // channel's group (its first value in row 0 of the batch element). With
  // a ring, C / V <= 256 (the plan sees to it): one column chunk, uniform
  // loops.
  const int cg_size = C / p.G;
  const int nvec = C / V;
  const int tpr = min(nvec, kThreads);  // threads along a row
  const int rpi = kThreads / tpr;       // rows per iteration
  const int tx = threadIdx.x % tpr, ty = threadIdx.x / tpr;
  const bool active = ty < rpi;
  const int width = tpr * V;  // channels covered by one column chunk
  for (int v0 = 0; v0 < nvec; v0 += tpr) {
    const int v = v0 + tx;
    const bool on = active && v < nvec;
    float acc[V], acc2[V], piv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
    if (!on) {
#pragma unroll
      for (int j = 0; j < V; ++j) piv[j] = 0.f;
    } else if (cg_size % V == 0) {  // the vector lies in one group
      const float k = to_f32(xb[v * V / cg_size * cg_size]);
#pragma unroll
      for (int j = 0; j < V; ++j) piv[j] = k;
    } else if (cg_size == 1) {  // each channel its own group
      load_vec<T, V>(xb + (size_t)v * V, piv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        piv[j] = to_f32(xb[(v * V + j) / cg_size * cg_size]);
    }
    for (int j = 0; j < nring; ++j) {  // streamed rows through the ring
      wait_ring(j);
      if (on)
        accumulate<T, V, kUnroll, false>(ring_slot(j), nullptr, ring_len(j),
                                         C, v, ty, rpi, piv, acc, acc2);
      __syncthreads();  // the slot is free again
      if (threadIdx.x == 0 && j + kStages < 2 * nring)
        fetch_ring(j + kStages);
    }
    if (!nring && on)  // streamed rows with 16-byte loads
      accumulate<T, V, kUnroll, false>(xb + (size_t)s0 * C, nullptr, r1 - s0,
                                       C, v, ty, rpi, piv, acc, acc2);
    if (bulk) {
      for (int k = 0; k < nchunks; ++k) {
        mbar_wait(&bars[k], 0);  // every thread: apply reads the whole tile
        const int c_r0 = k * chunk_rows;
        if (on)
          accumulate<T, V, kUnroll, false>(
              tile + (size_t)c_r0 * C, nullptr,
              min(chunk_rows, nres - c_r0), C, v, ty, rpi, piv, acc, acc2);
      }
    } else if (on) {  // the resident rows copied by the threads
      accumulate<T, V, kUnroll, true>(xb + (size_t)r0 * C, tile, nres, C, v,
                                      ty, rpi, piv, acc, acc2);
    }
    // block reduction over ty, a tree in a fixed order: sums, then sums
    // of squares; row y takes row y + half while h rows remain
    for (int round = 0; round < 2; ++round) {
      if (active) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          red[ty * width + tx * V + j] = round ? acc2[j] : acc[j];
      }
      __syncthreads();
      for (int h = rpi; h > 1;) {
        const int half = (h + 1) / 2;
        for (int k = threadIdx.x; k < (h - half) * width; k += kThreads)
          red[k] += red[k + half * width];
        __syncthreads();
        h = half;
      }
      for (int i = threadIdx.x; i < width; i += kThreads) {
        const int c = v0 * V + i;
        if (c < C) part[round * C + c] = red[i];
      }
      __syncthreads();
    }
  }

  // 3. the cluster's sums: every rank's partials gathered through
  // distributed shared memory into the scratch (a block of channels at a
  // time, eight independent loads per thread in flight), then summed in
  // rank order. A CTA alone needs no cluster barrier.
  if (cs == 1) {
    for (int c = threadIdx.x; c < 2 * C; c += kThreads) tot[c] = part[c];
  } else {
    cluster_arrive();
    cluster_wait();
    const int per = kScratch / cs;  // channels per block
    for (int c0 = 0; c0 < 2 * C; c0 += per) {
      const int nc = min(per, 2 * C - c0);
      for (int i0 = threadIdx.x; i0 < cs * nc; i0 += 8 * kThreads) {
        float got[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreads;
          if (i < cs * nc)
            got[u] = *cluster.map_shared_rank(part + c0 + i % nc, i / nc);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreads;
          if (i < cs * nc) red[i] = got[u];
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < nc; c += kThreads) {
        float s = 0.f;
        for (int q = 0; q < cs; ++q) s += red[q * nc + c];
        tot[c0 + c] = s;
      }
      __syncthreads();
    }
  }
  if (cs > 1) cluster_arrive();  // done reading the others' partials
  __syncthreads();
  const float count = (float)N * (float)cg_size;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g0 = c / cg_size * cg_size;
    float s = 0.f, s2 = 0.f;
    for (int k = 0; k < cg_size; ++k) {
      s += tot[g0 + k];
      s2 += tot[C + g0 + k];
    }
    // about the pivot: E[x] = k + E[x - k], var = E[(x-k)^2] - E[x-k]^2
    const float d = s / count;
    const float mean = to_f32(xb[g0]) + d;
    const float var = fmaxf(s2 / count - d * d, 0.f);
    const float a = rsqrtf(var + p.eps) * coef[c];
    coef[C + c] -= mean * a;
    coef[c] = a;
  }
  __syncthreads();

  // 4. apply (+GLU): streamed rows again (likely L2 hits), then the tile
  const int c_out = GLU ? C / 2 : C;
  const int nvo = c_out / V;
  const int tpo = min(nvo, kThreads);
  const int rpo = kThreads / tpo;
  const int ox = threadIdx.x % tpo, oy = threadIdx.x / tpo;
  T* yb = static_cast<T*>(p.y) + (size_t)b * N * c_out;
  for (int v0 = 0; v0 < nvo; v0 += tpo) {
    const int v = v0 + ox;
    const bool on = oy < rpo && v < nvo;
    const int c0 = (on ? v : 0) * V;
    float a[V], bb[V], ag[V], bg[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = coef[c0 + j];
      bb[j] = coef[C + c0 + j];
      ag[j] = GLU ? coef[c_out + c0 + j] : 0.f;
      bg[j] = GLU ? coef[C + c_out + c0 + j] : 0.f;
    }
    for (int j = nring; j < 2 * nring; ++j) {
      wait_ring(j);
      if (on)
        apply_rows<T, V, kApplyUnroll, GLU>(
            ring_slot(j),
            yb + (size_t)(s0 + (j - nring) * p.ring_rows) * c_out,
            ring_len(j), C, c_out, c0, oy, rpo, a, bb, ag, bg, true);
      __syncthreads();
      if (threadIdx.x == 0 && j + kStages < 2 * nring)
        fetch_ring(j + kStages);
    }
    if (!nring && on)
      apply_rows<T, V, kApplyUnroll, GLU>(
          xb + (size_t)s0 * C, yb + (size_t)s0 * c_out, r1 - s0, C, c_out,
          c0, oy, rpo, a, bb, ag, bg, true);
    if (on)
      apply_rows<T, V, kApplyUnroll, GLU>(tile, yb + (size_t)r0 * c_out, nres,
                                          C, c_out, c0, oy, rpo, a, bb, ag,
                                          bg, s0 < r1);
  }
  if (cs > 1) cluster_wait();  // no CTA leaves while others read it
}

template <typename T, int V>
const void* by_glu(int use_glu) {
  return use_glu ? (const void*)gn_fused_kernel<T, V, true>
                 : (const void*)gn_fused_kernel<T, V, false>;
}

// The kernel instance for (dtype, vector width, GLU), or null.
const void* kernel_for(int dtype, int vec, int use_glu) {
  if (dtype == 0 && vec == 4) return by_glu<float, 4>(use_glu);
  if (dtype == 0 && vec == 1) return by_glu<float, 1>(use_glu);
  if (dtype == 1 && vec == 8) return by_glu<__nv_bfloat16, 8>(use_glu);
  if (dtype == 1 && vec == 1) return by_glu<__nv_bfloat16, 1>(use_glu);
  return nullptr;
}

cudaLaunchConfig_t launch_config(int grid_x, int grid_y, int cluster,
                                 int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---------------------------------------------------------------------------
// K1 backward: the gradients (dx, dscale, dbias) of the forward above for an
// output cotangent dy. No TPU kernel is replaced: the JAX package's backward
// (_gn_bwd) is autodiff of its reference; autograd through the port's fp32
// twin launches some forty fp32 elementwise kernels and reductions per
// call, each reading or writing the whole activation. Same mathematics as
// that VJP, per (batch, group) of M = N * C/G values, the statistics
// recomputed about the forward's pivot k:
//   dyh = dy * scale_c (with GLU, dy of the halves first: da = dout * s,
//   dg = dout * a * s * (1 - s), where a, g and s = sigmoid(g) are the
//   forward's, rounded where the forward rounds them);
//   dx = r * (dyh - mean(dyh) - xh * mean(dyh * xh)), xh = (x - mean) * r;
//   per channel, P = sum dy and Q = sum dy * (x - k) over the rows, so that
//   dbias = P, dscale = r * (Q - d * P) with d = mean - k, and the group's
//   sum dyh * xh = r * sum_c scale_c * (Q_c - d * P_c): sums about the pivot
//   that do not cancel where |mean| >> std. All in fp32; dx is rounded to
//   x's dtype once, dscale and dbias stay fp32.
//
// Bound: device-memory bytes (x and dy read once, dx written once). The
// design is the forward's: one cluster per batch element (grid (cluster,
// B)), each CTA owning a row range, rows kept in shared memory where the
// plan (ops/groupnorm.py::_bwd_plan) has room, per-channel partials summed
// in rank order through distributed shared memory. The passes over a CTA's
// rows:
//   1. sums of (x - k) and (x - k)^2 and, without GLU, P and Q; the kept
//      rows of x (and dy, where dx is wanted) copied to shared memory;
//   2. with GLU only (a and g need the statistics): P and Q from the
//      recomputed forward; the kept rows of dout copied;
//   3. dx, where wanted.
// Kept rows are read from device memory once. Rows beyond them are read
// again in each later pass, each pass in the order opposite to the one
// before, so that it starts on the rows the last left in L2. Each cluster
// writes its batch element's dscale and dbias to a (B, 2C) fp32 scratch;
// gn_bwd_param_kernel sums it over B in a fixed order. No atomics: every
// output is bit-reproducible run to run.

struct BwdParams {
  const void* x;
  const void* dy;  // (B, N, C), or (B, N, C/2) with GLU
  const float* scale;
  const float* bias;
  void* dx;     // (B, N, C), or null: no dx
  float* part;  // (B, 2C): dscale, dbias of each batch element; or null
  int N, C, G;
  int rows;      // rows per CTA (the last may have fewer)
  int res_rows;  // rows per CTA kept in shared memory
  float eps;
};

// Bytes of shared memory before the kept rows: a scratch of kThreads * V
// floats (block reductions, then the cluster's partials gathered), the
// partials and the cluster's sums (4C floats each) and eight C float arrays
// of per-channel coefficients. ops/groupnorm.py's _bwd_fixed_smem computes
// the same number.
__host__ __device__ inline int bwd_tile_offset(int C, int V) {
  const int raw = (kThreads * V + 16 * C) * 4;
  return (raw + 127) / 128 * 128;
}

// The per-channel coefficients of this thread's V channels.
template <int V>
struct Coefs {
  float a[V];   // r * scale: the forward's slope, and dx's factor of dy
  float b[V];   // the forward's offset, bias - mean * a
  float k[V];   // the pivot
  float mu[V];  // the group's mean
  float bt[V];  // dx's factor of (x - mean)
  float ct[V];  // dx's constant
};

struct BwdSmem {
  const float *a, *b, *k, *mu, *bt, *ct;
};

template <int V>
__device__ __forceinline__ void load_coefs(Coefs<V>& q, const BwdSmem& s,
                                           int c0) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    q.a[j] = s.a[c0 + j];
    q.b[j] = s.b[c0 + j];
    q.k[j] = s.k[c0 + j];
    q.mu[j] = s.mu[c0 + j];
    q.bt[j] = s.bt[c0 + j];
    q.ct[j] = s.ct[c0 + j];
  }
}

// The cotangents of a GLU's two halves at V elements: the forward
// recomputed and rounded to T where K1 rounds it (bf16 pairs rounded by one
// instruction, as the forward's GLU does), then da = dout * s and dg = dout
// * a * s * (1 - s) in fp32
template <typename T, int V>
__device__ __forceinline__ void glu_grads(const float (&xa)[V],
                                          const float (&xg)[V],
                                          const float (&dout)[V],
                                          const Coefs<V>& qa,
                                          const Coefs<V>& qg, float (&da)[V],
                                          float (&dg)[V]) {
  float av[V], s[V];
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float2 a2 = round_pair(fmaf(xa[j], qa.a[j], qa.b[j]),
                                   fmaf(xa[j + 1], qa.a[j + 1], qa.b[j + 1]));
      const float2 g2 = round_pair(fmaf(xg[j], qg.a[j], qg.b[j]),
                                   fmaf(xg[j + 1], qg.a[j + 1], qg.b[j + 1]));
      const float2 s2 = round_pair(rcp_approx(1.f + __expf(-g2.x)),
                                   rcp_approx(1.f + __expf(-g2.y)));
      av[j] = a2.x;
      av[j + 1] = a2.y;
      s[j] = s2.x;
      s[j + 1] = s2.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      av[j] = round_to<T>(fmaf(xa[j], qa.a[j], qa.b[j]));
      const float gv = round_to<T>(fmaf(xg[j], qg.a[j], qg.b[j]));
      s[j] = round_to<T>(rcp_approx(1.f + __expf(-gv)));
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    da[j] = dout[j] * s[j];
    dg[j] = dout[j] * av[j] * s[j] * (1.f - s[j]);
  }
}

// A vector of V values of T from p: its raw bits, and as fp32
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Pack<T, V>& pk,
                                       float (&out)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f32(pk.v[j]);
}

// V fp32 values rounded to T and stored at p (bf16 pairs rounded by one
// instruction); `once`: evict-first in L2
template <typename T, int V>
__device__ __forceinline__ void store_rounded(T* p, const float (&in)[V],
                                              bool once) {
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
    Pack<T, V> pk;
#pragma unroll
    for (int j = 0; j < V; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(&pk.v[j]) =
          __floats2bfloat162_rn(in[j], in[j + 1]);
    if constexpr (sizeof(pk) == 16) {
      if (once) {
        __stcs(reinterpret_cast<int4*>(p),
               *reinterpret_cast<const int4*>(&pk));
        return;
      }
    }
    *reinterpret_cast<Pack<T, V>*>(p) = pk;
  } else {
    store_vec<T, V>(p, in, once);
  }
}

// The rows this thread takes of [0, nrows), U at a time: rows ty + t *
// step + u * rpi for steps t in order, or in reverse order
struct RowSteps {
  int ty, rpi, step, n;
  bool reverse;
  __device__ RowSteps(int nrows, int ty_, int rpi_, int U, bool rev)
      : ty(ty_), rpi(rpi_), step(U * rpi_),
        n(nrows > ty_ ? (nrows - ty_ + U * rpi_ - 1) / (U * rpi_) : 0),
        reverse(rev) {}
  __device__ int first(int t) const {
    return ty + (reverse ? n - 1 - t : t) * step;
  }
};

// Pass 1 over rows [0, nrows) of xs (row stride C) and, without GLU, gs
// (row stride C), at channels [c0, c0 + V): the sums of (x - k), (x - k)^2
// and, without GLU, of dy and dy * (x - k). Non-null xkeep / gkeep take a
// copy of each vector read.
template <typename T, int V, int U, bool GLU>
__device__ __forceinline__ void stat_rows(
    const T* xs, const T* gs, T* xkeep, T* gkeep, int nrows, int C, int c0,
    const RowSteps& rs, const float (&k)[V], float (&s)[V], float (&s2)[V],
    float (&sp)[V], float (&sq)[V]) {
  for (int t = 0; t < rs.n; ++t) {
    const int r = rs.first(t);
    Pack<T, V> px[U], pg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rs.rpi;
      if (rr < nrows) {
        px[u] = load_pack<T, V>(xs + (size_t)rr * C + c0);
        if constexpr (!GLU) pg[u] = load_pack<T, V>(gs + (size_t)rr * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rs.rpi;
      if (rr >= nrows) continue;
      if (xkeep) {
        *reinterpret_cast<Pack<T, V>*>(xkeep + (size_t)rr * C + c0) = px[u];
        if (!GLU && gkeep)
          *reinterpret_cast<Pack<T, V>*>(gkeep + (size_t)rr * C + c0) =
              pg[u];
      }
      float e[V], g[V];
      unpack<T, V>(px[u], e);
      if constexpr (!GLU) unpack<T, V>(pg[u], g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = e[j] - k[j];
        s[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
        if constexpr (!GLU) {
          sp[j] += g[j];
          sq[j] = fmaf(g[j], d, sq[j]);
        }
      }
    }
  }
}

// Pass 2 (GLU) over rows [0, nrows) of xs (row stride C) and gs (the
// cotangent, row stride C/2), at output channels [c0, c0 + V): P and Q of
// both halves. A non-null gkeep takes a copy of each cotangent vector.
template <typename T, int V, int U>
__device__ __forceinline__ void glu_rows(
    const T* xs, const T* gs, T* gkeep, int nrows, int C, int c0,
    const RowSteps& rs, const Coefs<V>& qa, const Coefs<V>& qg,
    float (&pa)[V], float (&sa)[V], float (&pg)[V], float (&sg)[V]) {
  const int h = C / 2;
  for (int t = 0; t < rs.n; ++t) {
    const int r = rs.first(t);
    Pack<T, V> pa_x[U], pg_x[U], p_g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rs.rpi;
      if (rr < nrows) {
        pa_x[u] = load_pack<T, V>(xs + (size_t)rr * C + c0);
        pg_x[u] = load_pack<T, V>(xs + (size_t)rr * C + h + c0);
        p_g[u] = load_pack<T, V>(gs + (size_t)rr * h + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rs.rpi;
      if (rr >= nrows) continue;
      if (gkeep)
        *reinterpret_cast<Pack<T, V>*>(gkeep + (size_t)rr * h + c0) = p_g[u];
      float xa[V], xg[V], g[V], da[V], dg[V];
      unpack<T, V>(pa_x[u], xa);
      unpack<T, V>(pg_x[u], xg);
      unpack<T, V>(p_g[u], g);
      glu_grads<T, V>(xa, xg, g, qa, qg, da, dg);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        pa[j] += da[j];
        sa[j] = fmaf(da[j], xa[j] - qa.k[j], sa[j]);
        pg[j] += dg[j];
        sg[j] = fmaf(dg[j], xg[j] - qg.k[j], sg[j]);
      }
    }
  }
}

// Pass 3: dx of rows [0, nrows) of xs (row stride C) and gs (row stride C,
// or C/2 with GLU) into ds (row stride C), at output channels [c0, c0 + V)
// (and c0 + C/2 with GLU): dx = a dy + bt (x - mean) + ct. `once`: store
// evict-first.
template <typename T, int V, int U, bool GLU>
__device__ __forceinline__ void dx_rows(const T* xs, const T* gs, T* ds,
                                        int nrows, int C, int c0,
                                        const RowSteps& rs,
                                        const Coefs<V>& qa,
                                        const Coefs<V>& qg, bool once) {
  const int cd = GLU ? C / 2 : C;
  for (int t = 0; t < rs.n; ++t) {
    const int r = rs.first(t);
    Pack<T, V> pa_x[U], pg_x[U], p_g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rs.rpi;
      if (rr < nrows) {
        pa_x[u] = load_pack<T, V>(xs + (size_t)rr * C + c0);
        if constexpr (GLU)
          pg_x[u] = load_pack<T, V>(xs + (size_t)rr * C + cd + c0);
        p_g[u] = load_pack<T, V>(gs + (size_t)rr * cd + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * rs.rpi;
      if (rr >= nrows) continue;
      float xa[V], xg[V], g[V], da[V], dg[V], oa[V], og[V];
      unpack<T, V>(pa_x[u], xa);
      unpack<T, V>(p_g[u], g);
      if constexpr (GLU) {
        unpack<T, V>(pg_x[u], xg);
        glu_grads<T, V>(xa, xg, g, qa, qg, da, dg);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        oa[j] = fmaf(qa.a[j], GLU ? da[j] : g[j],
                     fmaf(qa.bt[j], xa[j] - qa.mu[j], qa.ct[j]));
        if constexpr (GLU)
          og[j] = fmaf(qg.a[j], dg[j],
                       fmaf(qg.bt[j], xg[j] - qg.mu[j], qg.ct[j]));
      }
      store_rounded<T, V>(ds + (size_t)rr * C + c0, oa, once);
      if constexpr (GLU) store_rounded<T, V>(ds + (size_t)rr * C + cd + c0,
                                             og, once);
    }
  }
}

// The block's sums of acc over ty (rows of threads), a tree in a fixed
// order as in the forward, stored at dst[0, min(width, n))
template <int V>
__device__ __forceinline__ void block_sum(float* red, const float (&acc)[V],
                                          bool active, int tx, int ty,
                                          int rpi, int width, float* dst,
                                          int n) {
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[ty * width + tx * V + j] = acc[j];
  }
  __syncthreads();
  for (int h = rpi; h > 1;) {
    const int half = (h + 1) / 2;
    for (int k = threadIdx.x; k < (h - half) * width; k += kThreads)
      red[k] += red[k + half * width];
    __syncthreads();
    h = half;
  }
  for (int i = threadIdx.x; i < min(width, n); i += kThreads) dst[i] = red[i];
  __syncthreads();
}

// dst[0, n) = the sums of src[0, n) over the cluster's CTAs, in rank order,
// gathered through distributed shared memory as the forward does (red: a
// scratch of kThreads * V floats). Opens with a cluster barrier (every
// CTA's src written); the caller arrives once more after its last gather
// and waits before it exits, so that no CTA leaves while another reads it.
template <int V>
__device__ __forceinline__ void cluster_sum(int cs, float* red, float* src,
                                            float* dst, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  if (cs == 1) {
    for (int c = threadIdx.x; c < n; c += kThreads) dst[c] = src[c];
    __syncthreads();
    return;
  }
  cluster_arrive();
  cluster_wait();
  const int per = kThreads * V / cs;  // values per block
  for (int c0 = 0; c0 < n; c0 += per) {
    const int nc = min(per, n - c0);
    for (int i0 = threadIdx.x; i0 < cs * nc; i0 += 8 * kThreads) {
      float got[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < cs * nc)
          got[u] = *cluster.map_shared_rank(src + c0 + i % nc, i / nc);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < cs * nc) red[i] = got[u];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      float s = 0.f;
      for (int q = 0; q < cs; ++q) s += red[q * nc + c];
      dst[c0 + c] = s;
    }
    __syncthreads();
  }
}

// The thread layout of a pass over rows of nv vectors: tpr threads along a
// row, rpi rows at a time
struct Lanes {
  int tpr, rpi, tx, ty, width;
  bool active;
  __device__ Lanes(int nv, int V) {
    tpr = min(nv, kThreads);
    rpi = kThreads / tpr;
    tx = threadIdx.x % tpr;
    ty = threadIdx.x / tpr;
    active = ty < rpi;
    width = tpr * V;
  }
};

// One cluster per batch element (blockIdx.y), one CTA per cluster rank.
template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2) gn_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // rows in flight per thread: x alone in pass 1 under GLU, else two or
  // three vectors a row
  constexpr int kStatUnroll = GLU ? 4 : 2;
  constexpr int kRowUnroll = 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int N = p.N, C = p.C;
  const int h = C / 2;
  const int cd = GLU ? h : C;  // the cotangent's channels
  const int r0 = min(N, rank * p.rows);
  const int r1 = min(N, r0 + p.rows);
  const int nres = min(p.res_rows, r1 - r0);
  const int s0 = r0 + nres;  // first row read again in each pass
  const bool want_dx = p.dx != nullptr;

  float* red = reinterpret_cast<float*>(smem);
  float* part = red + kThreads * V;  // sums (x-k), (x-k)^2, P, Q: 4C
  float* tot = part + 4 * C;         // the cluster's: 4C
  float* piv = tot + 4 * C;
  float* dd = piv + C;  // mean - k
  float* mu = dd + C;
  float* rs = mu + C;   // r of the channel's group
  float* al = rs + C;   // the scale, then r * scale
  float* be = al + C;   // the bias, then bias - mean * r * scale
  float* bt = be + C;
  float* ct = bt + C;
  const BwdSmem coef{al, be, piv, mu, bt, ct};
  T* xt = reinterpret_cast<T*>(smem + bwd_tile_offset(C, V));
  T* gt = xt + (size_t)p.res_rows * C;  // kept rows of dy, where dx is wanted
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * N * C;
  const T* gb = static_cast<const T*>(p.dy) + (size_t)b * N * cd;
  T* db = want_dx ? static_cast<T*>(p.dx) + (size_t)b * N * C : nullptr;
  const int cg_size = C / p.G;
  const float count = (float)N * (float)cg_size;

  for (int c = threadIdx.x; c < C; c += kThreads) {
    piv[c] = to_f32(xb[c / cg_size * cg_size]);  // as the forward's pivot
    al[c] = p.scale[c];
    be[c] = p.bias[c];
  }
  __syncthreads();

  // 1. the statistics' sums (and without GLU P and Q); rows kept
  {
    const Lanes ln(C / V, V);
    for (int v0 = 0; v0 < C / V; v0 += ln.tpr) {
      const int v = v0 + ln.tx;
      const bool on = ln.active && v < C / V;
      const int c0 = v * V;
      float k[V], s[V], s2[V], sp[V], sq[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        k[j] = on ? piv[c0 + j] : 0.f;
        s[j] = s2[j] = sp[j] = sq[j] = 0.f;
      }
      if (on) {
        stat_rows<T, V, kStatUnroll, GLU>(
            xb + (size_t)r0 * C, gb + (size_t)r0 * cd, xt,
            want_dx ? gt : nullptr, nres, C, c0,
            RowSteps(nres, ln.ty, ln.rpi, kStatUnroll, false), k, s, s2, sp,
            sq);
        stat_rows<T, V, kStatUnroll, GLU>(
            xb + (size_t)s0 * C, gb + (size_t)s0 * cd, nullptr, nullptr,
            r1 - s0, C, c0,
            RowSteps(r1 - s0, ln.ty, ln.rpi, kStatUnroll, false), k, s, s2,
            sp, sq);
      }
      const int n = C - v0 * V;
      block_sum<V>(red, s, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                   part + v0 * V, n);
      block_sum<V>(red, s2, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                   part + C + v0 * V, n);
      if constexpr (!GLU) {
        block_sum<V>(red, sp, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                     part + 2 * C + v0 * V, n);
        block_sum<V>(red, sq, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                     part + 3 * C + v0 * V, n);
      }
    }
  }
  cluster_sum<V>(cs, red, part, tot, GLU ? 2 * C : 4 * C);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g0 = c / cg_size * cg_size;
    float s = 0.f, s2 = 0.f;
    for (int q = 0; q < cg_size; ++q) {
      s += tot[g0 + q];
      s2 += tot[C + g0 + q];
    }
    // as the forward: E[x] = k + E[x - k], var = E[(x-k)^2] - E[x-k]^2
    const float d = s / count;
    const float var = fmaxf(s2 / count - d * d, 0.f);
    const float r = rsqrtf(var + p.eps);
    const float a = r * al[c];
    dd[c] = d;
    mu[c] = piv[c] + d;
    rs[c] = r;
    be[c] -= mu[c] * a;
    al[c] = a;
  }
  __syncthreads();

  // 2. with GLU, P and Q from the recomputed forward, the rows beyond the
  // kept ones in reverse order; the kept rows' dout copied
  if constexpr (GLU) {
    const Lanes ln(h / V, V);
    for (int v0 = 0; v0 < h / V; v0 += ln.tpr) {
      const int v = v0 + ln.tx;
      const bool on = ln.active && v < h / V;
      const int c0 = v * V;
      float pa[V], sa[V], pg[V], sg[V];
#pragma unroll
      for (int j = 0; j < V; ++j) pa[j] = sa[j] = pg[j] = sg[j] = 0.f;
      if (on) {
        Coefs<V> qa, qg;
        load_coefs<V>(qa, coef, c0);
        load_coefs<V>(qg, coef, h + c0);
        glu_rows<T, V, kRowUnroll>(
            xt, gb + (size_t)r0 * h, want_dx ? gt : nullptr, nres, C, c0,
            RowSteps(nres, ln.ty, ln.rpi, kRowUnroll, false), qa, qg, pa, sa,
            pg, sg);
        glu_rows<T, V, kRowUnroll>(
            xb + (size_t)s0 * C, gb + (size_t)s0 * h, nullptr, r1 - s0, C,
            c0, RowSteps(r1 - s0, ln.ty, ln.rpi, kRowUnroll, true), qa, qg,
            pa, sa, pg, sg);
      }
      const int n = h - v0 * V;
      block_sum<V>(red, pa, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                   part + 2 * C + v0 * V, n);
      block_sum<V>(red, sa, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                   part + 3 * C + v0 * V, n);
      block_sum<V>(red, pg, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                   part + 2 * C + h + v0 * V, n);
      block_sum<V>(red, sg, ln.active, ln.tx, ln.ty, ln.rpi, ln.width,
                   part + 3 * C + h + v0 * V, n);
    }
    cluster_sum<V>(cs, red, part + 2 * C, tot + 2 * C, 2 * C);
  }

  // dx's coefficients per channel, and this batch element's dscale, dbias.
  // The group's r is common to its channels: with al = r * scale,
  // r * sum dyh = sum al P and r * sum dyh * (x - mean) = sum al (Q - d P).
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g0 = c / cg_size * cg_size;
    const float r = rs[c], d = dd[c];
    float sp = 0.f, sq = 0.f;
    for (int q = 0; q < cg_size; ++q) {
      const float w = al[g0 + q], pq = tot[2 * C + g0 + q];
      sp = fmaf(w, pq, sp);
      sq = fmaf(w, tot[3 * C + g0 + q] - d * pq, sq);
    }
    bt[c] = -r * r * sq / count;
    ct[c] = -sp / count;
    if (p.part && c % cs == rank) {
      const float pc = tot[2 * C + c];
      p.part[(size_t)b * 2 * C + c] = r * (tot[3 * C + c] - d * pc);
      p.part[(size_t)b * 2 * C + C + c] = pc;
    }
  }
  __syncthreads();
  if (cs > 1) cluster_arrive();  // done reading the others' partials

  // 3. dx: the kept rows from shared memory, the rest once more in the
  // order opposite to the last pass's
  if (want_dx) {
    const Lanes ln(cd / V, V);
    for (int v0 = 0; v0 < cd / V; v0 += ln.tpr) {
      const int v = v0 + ln.tx;
      if (!ln.active || v >= cd / V) continue;
      const int c0 = v * V;
      Coefs<V> qa, qg;
      load_coefs<V>(qa, coef, c0);
      if constexpr (GLU) load_coefs<V>(qg, coef, h + c0);
      dx_rows<T, V, kRowUnroll, GLU>(
          xt, gt, db + (size_t)r0 * C, nres, C, c0,
          RowSteps(nres, ln.ty, ln.rpi, kRowUnroll, false), qa, qg, s0 < r1);
      dx_rows<T, V, kRowUnroll, GLU>(
          xb + (size_t)s0 * C, gb + (size_t)s0 * cd, db + (size_t)s0 * C,
          r1 - s0, C, c0, RowSteps(r1 - s0, ln.ty, ln.rpi, kRowUnroll, !GLU),
          qa, qg, true);
    }
  }
  if (cs > 1) cluster_wait();  // no CTA leaves while others read it
}

// out[i] = sum over b of part[b * n + i], b in order: dscale and dbias
// from the batch elements' partials
__global__ void __launch_bounds__(kThreads) gn_bwd_param_kernel(
    const float* part, float* out, int B, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < B; ++b) s += part[(size_t)b * n + i];
  out[i] = s;
}

template <typename T, int V>
const void* bwd_by_glu(int use_glu) {
  return use_glu ? (const void*)gn_bwd_kernel<T, V, true>
                 : (const void*)gn_bwd_kernel<T, V, false>;
}

// The backward instance for (dtype, vector width, GLU), or null. With GLU
// bf16 vectors are 4 wide (8 bytes): a thread holds both halves'
// coefficients.
const void* bwd_kernel_for(int dtype, int vec, int use_glu) {
  if (dtype == 0 && vec == 4) return bwd_by_glu<float, 4>(use_glu);
  if (dtype == 0 && vec == 1) return bwd_by_glu<float, 1>(use_glu);
  if (dtype == 1 && vec == 8 && !use_glu)
    return (const void*)gn_bwd_kernel<__nv_bfloat16, 8, false>;
  if (dtype == 1 && vec == 4 && use_glu)
    return (const void*)gn_bwd_kernel<__nv_bfloat16, 4, true>;
  if (dtype == 1 && vec == 1) return bwd_by_glu<__nv_bfloat16, 1>(use_glu);
  return nullptr;
}

// Sets the opt-in shared memory, clusters of 16 and the largest carveout
// on kernel k.
cudaError_t set_attributes(const void* k) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

extern "C" {

// Sets every kernel instance's function attributes on the current device,
// the forward's and the backward's: the opt-in shared memory, clusters of
// 16 (non-portable), and the largest shared-memory carveout. Call once per
// device before the first launch.
int objgan_group_norm_setup() {
  const int vecs[] = {1, 4, 8};
  for (int i = 0; i < 24; ++i) {  // direction x dtype x vec x GLU
    const int dtype = i % 2, vec = vecs[i / 2 % 3], glu = i / 6 % 2;
    const void* k = i < 12 ? kernel_for(dtype, vec, glu)
                           : bwd_kernel_for(dtype, vec, glu);
    if (!k) continue;
    const cudaError_t err = set_attributes(k);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  return 0;
}

// How many clusters of `cluster` CTAs with `smem` bytes each of K1's
// instance (K1 backward's if `backward`) the current device can hold at
// once, into *out (0: it cannot launch the plan).
int objgan_group_norm_max_clusters(int backward, int dtype, int vec,
                                   int use_glu, int cluster, int smem,
                                   int* out) {
  const void* k = backward ? bwd_kernel_for(dtype, vec, use_glu)
                           : kernel_for(dtype, vec, use_glu);
  if (!k || cluster < 1 || cluster > kMaxCluster) return 1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, 1, cluster, smem, 0, &attr);
  cudaError_t err = cudaOccupancyMaxActiveClusters(out, k, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16; vec: 16 / itemsize or 1. x (B, N, C)
// contiguous; y (B, N, C) or (B, N, C/2) with use_glu; scale/bias (C,) fp32.
// Launches grid (cluster, B) in clusters of `cluster`; CTA r owns rows
// [r * rows, (r + 1) * rows) of its batch element and keeps the first
// res_rows of them in shared memory, copied by
// bulk copies if `bulk` (else by the threads); the rest stream through a
// ring of kStages slots of ring_rows rows (0: no ring, 16-byte loads).
// `smem` bytes of dynamic shared memory. Returns 0 when launched,
// cudaErrorInvalidValue (1) for a plan this file does not take, else the
// launch's error.
int objgan_group_norm(const void* x, void* y, const void* scale,
                      const void* bias, int dtype, int vec, int B, int N,
                      int C, int G, int cluster, int rows, int res_rows,
                      int ring_rows, int bulk, int smem, float eps,
                      int use_glu, void* stream) {
  const void* k = kernel_for(dtype, vec, use_glu);
  const long long row = (long long)C * (dtype == 0 ? 4 : 2);
  const bool ok =
      k && B >= 1 && B <= 65535 && N >= 1 && C >= 1 && G >= 1 && C % G == 0 &&
      (!use_glu || C % 2 == 0) && C % vec == 0 &&
      (!use_glu || (C / 2) % vec == 0) && cluster >= 1 &&
      cluster <= kMaxCluster && rows >= 1 &&
      (long long)rows * cluster >= N && res_rows >= 0 && res_rows <= rows &&
      ring_rows >= 0 && (ring_rows == 0 || (vec > 1 && C / vec <= 256)) &&
      smem <= kMaxSmem &&
      tile_offset(C, vec) + ((long long)kStages * ring_rows + res_rows) * row <=
          smem &&
      (vec == 1 || (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  Params p{x,    y,        static_cast<const float*>(scale),
           static_cast<const float*>(bias),
           N,    C,        G,
           rows, res_rows, ring_rows,
           bulk, eps};
  void* args[] = {&p};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(
      cluster, B, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelExC(&cfg, k, args);
  if (err != cudaSuccess) cudaGetLastError();  // not sticky: clear it
  return (int)err;
}

// K1 backward. x (B, N, C) and dy (B, N, C), or (B, N, C/2) with use_glu,
// contiguous, of `dtype` (0 = float32, 1 = bfloat16); scale/bias (C,) fp32.
// dx (B, N, C) of x's dtype, or null; part (B, 2C) fp32 scratch and
// dparams (2C,) fp32 (dscale, then dbias), both or neither. vec: 16 /
// itemsize (4 for bf16 with GLU) or 1. Launches gn_bwd_kernel on grid
// (cluster, B) in clusters of `cluster`, CTA r owning rows [r * rows, (r +
// 1) * rows) and keeping res_rows of them, `smem` bytes of dynamic shared
// memory; then, with dparams, gn_bwd_param_kernel. Returns 0 when launched,
// cudaErrorInvalidValue (1) for arguments this file does not take, else
// the launch's error.
int objgan_group_norm_bwd(const void* x, const void* dy, const void* scale,
                          const void* bias, void* dx, void* part,
                          void* dparams, int dtype, int vec, int B, int N,
                          int C, int G, int cluster, int rows, int res_rows,
                          int smem, float eps, int use_glu, void* stream) {
  const void* k = bwd_kernel_for(dtype, vec, use_glu);
  const long long item = dtype == 0 ? 4 : 2;
  const long long cd = use_glu ? C / 2 : C;
  const long long keep = ((long long)C + (dx ? cd : 0)) * item;
  const bool ok =
      k && B >= 1 && B <= 65535 && N >= 1 && C >= 1 && G >= 1 && C % G == 0 &&
      (!use_glu || C % 2 == 0) && cd % vec == 0 && C % vec == 0 &&
      cluster >= 1 && cluster <= kMaxCluster && rows >= 1 &&
      (long long)rows * cluster >= N && res_rows >= 0 && res_rows <= rows &&
      (dx || part) && (!part == !dparams) && smem <= kMaxSmem &&
      bwd_tile_offset(C, vec) + res_rows * keep <= smem &&
      (vec == 1 || (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dx) % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  BwdParams p{x,     dy,   static_cast<const float*>(scale),
              static_cast<const float*>(bias),
              dx,    static_cast<float*>(part),
              N,     C,    G,
              rows,  res_rows, eps};
  void* args[] = {&p};
  cudaLaunchAttribute attr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = launch_config(cluster, B, cluster, smem, s, &attr);
  cudaError_t err = cudaLaunchKernelExC(&cfg, k, args);
  if (err == cudaSuccess && part) {
    gn_bwd_param_kernel<<<(2 * C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dparams), B,
        2 * C);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) cudaGetLastError();  // not sticky: clear it
  return (int)err;
}

}  // extern "C"
