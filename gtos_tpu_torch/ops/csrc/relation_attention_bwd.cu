// Relation-aware graph attention over the batch-global relation bank,
// backward, for Hopper (sm_90a).
//
// Replaces: gtos_tpu/ops/pallas/relation_attention_bwd.py `_bwd_kernel`
// (wrapper `fused_relation_attention_bwd`, called by the custom VJP
// `_rel_attn_bwd` in relation_attention.py).
//
// From the score tables t2, t3 [B, H, N, P] (t4 folded into t2, as B3 takes
// them) and the output's cotangent g [B, H, N, Dh], for graph b, head h,
// r = idx[b, i, j]:
//   attn_ij = softmax_j((q_i.k_j + t2[i, r] + t3[j, r]) * scale + mask_j)
//   gv_j    = sum_i attn_ij g_i
//   ge_ij   = attn_ij * (g_i.v_j - sum_j' attn_ij' g_i.v_j') * scale
//   gq_i    = sum_j ge_ij k_j             gk_j = sum_i ge_ij q_i
//   g_t2[b, i, h, p] = sum_{j: idx[b,i,j] = p} ge_ij
//   g_t3[b, j, h, p] = sum_{i: idx[b,i,j] = p} ge_ij
// with attn in f32 (not rounded), every sum in f32, gq/gk/gv in f32 and the
// table gradients in the table type, row-major [B, N, H, P] and dense: every
// entry is written, zero where no pair refers to it. As the TPU kernel's
// one-hot matmuls in the table type do, each ge_ij is rounded to the table
// type before it is summed (relation_attention_bwd.py:145).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): about
// ten multiply-adds per pair and head dimension, a few hundred MFLOP per
// training batch, against the bytes of q, k, v, g, the referenced table
// entries, idx and the two walk orders read, gq/gk/gv written, and the
// dense g_t2/g_t3 written in full: the bytes bound it, most of them the
// dense table gradients.
//
// Design: the TPU kernel turns the gather's transpose into one-hot matmuls
// on the MXU, because Mosaic has no scatter. Here one 512-thread block owns
// a whole (graph, head): attn and ge [N, N] live in f32 shared memory, so
// the column sums gk and gv need neither atomics nor a second pass. The
// table gradients are written a row at a time by one warp: the row is
// zeroed, then each run of equal bank rows is summed in a fixed order and
// written once. The runs come from `row_order` / `col_order` [B, N, N], a
// stable argsort of each row of idx and of each column (built once per
// encoder stack): the warp stages the row's keys and values in that order
// in shared memory, and the lane at the head of a run sums the run's pairs
// in ascending pair order. No atomics anywhere: the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 128;              // node bucket limit (as the TPU kernel)
constexpr int kMaxJPL = kMaxN / 32;     // keys per lane in the score pass
constexpr int kMaxDPL = 4;              // head dims per lane: Dh <= 128
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the most a block can use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One dense row of a table gradient, by one warp: zero the row's P
// entries, then every run of equal keys in the sorted order `ord` [N] sums
// its values in that order (each rounded to T first) and writes the sum at
// its key. key(x) = keys[x * kstride], value(x) = vals[x * vstride]. The
// sorted keys and values are staged in the warp's shared buffers skeys /
// svals [N] first, so the lane at the head of a long run (the pad slot of
// a padded row) walks shared memory, not a chain of dependent loads.
template <typename T>
__device__ __forceinline__ void scatter_row(
    T* __restrict__ out, int P, const int32_t* __restrict__ ord,
    const int32_t* __restrict__ keys, int kstride, const float* vals,
    int vstride, int N, int lane, int* skeys, float* svals) {
  if ((static_cast<size_t>(P) * sizeof(T)) % 16 == 0) {
    uint4* out4 = reinterpret_cast<uint4*>(out);
    const int n4 = static_cast<int>(static_cast<size_t>(P) * sizeof(T) / 16);
    for (int c = lane; c < n4; c += 32) out4[c] = make_uint4(0, 0, 0, 0);
  } else {
    for (int p = lane; p < P; p += 32) out[p] = from_f32<T>(0.f);
  }
  for (int s = lane; s < N; s += 32) {
    const int x = __ldg(ord + s);
    skeys[s] = __ldg(keys + x * kstride);
    svals[s] = to_f32(from_f32<T>(vals[x * vstride]));
  }
  // the zeros land before the sums, and the staged row is complete
  // (memory order in the warp)
  __syncwarp();
  for (int s = lane; s < N; s += 32) {
    const int key = skeys[s];
    if (s > 0 && skeys[s - 1] == key) continue;
    float sum = 0.f;
    for (int t = s; t < N && skeys[t] == key; ++t) sum += svals[t];
    out[key] = from_f32<T>(sum);
  }
  __syncwarp();  // the buffers are read before the next row overwrites them
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rel_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const T* __restrict__ t2, const T* __restrict__ t3,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ row_order,
                    const int32_t* __restrict__ col_order,
                    float* __restrict__ gq, float* __restrict__ gk,
                    float* __restrict__ gv, T* __restrict__ gt2,
                    T* __restrict__ gt3, int H, int N, int Dh, int P,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* attn = reinterpret_cast<float*>(smem);  // [N][N]
  float* ge = attn + N * N;                      // [N][N]
  float* kT = ge + N * N;                        // [Dh][N]
  float* vT = kT + Dh * N;                       // [Dh][N]
  float* mask_add = vT + Dh * N;                 // [N]
  int* skeys = reinterpret_cast<int*>(mask_add + N);           // [kWarps][N]
  float* svals = reinterpret_cast<float*>(skeys + kWarps * N);  // [kWarps][N]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = bh * N * Dh;
  const int32_t* idx_b = idx + static_cast<size_t>(b) * N * N;

  for (int e = tid; e < N * Dh; e += kThreads) {
    const int j = e / Dh;
    const int d = e - j * Dh;
    kT[d * N + j] = to_f32(k[head + e]);
    vT[d * N + j] = to_f32(v[head + e]);
  }
  for (int j = tid; j < N; j += kThreads)
    mask_add[j] = mask[static_cast<size_t>(b) * N + j] ? 0.f : -1e9f;
  __syncthreads();

  // pass 1, one warp per query row, lanes across keys: the scores from the
  // tables, the softmax, g.v^T and ge
  for (int i = warp; i < N; i += kWarps) {
    float qr[kMaxDPL], gr[kMaxDPL];
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      const size_t o = head + static_cast<size_t>(i) * Dh + d;
      qr[t] = d < Dh ? to_f32(q[o]) : 0.f;
      gr[t] = d < Dh ? to_f32(g[o]) : 0.f;
    }
    float e[kMaxJPL], ga[kMaxJPL];
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) e[u] = ga[u] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      for (int dd = 0; dd < 32; ++dd) {
        const int d = 32 * t + dd;
        if (d >= Dh) break;  // the same for every lane
        const float qd = __shfl_sync(0xffffffffu, qr[t], dd);
        const float gd = __shfl_sync(0xffffffffu, gr[t], dd);
#pragma unroll
        for (int u = 0; u < kMaxJPL; ++u) {
          const int j = lane + 32 * u;
          if (j < N) {
            e[u] += qd * kT[d * N + j];
            ga[u] += gd * vT[d * N + j];
          }
        }
      }
    }
    const int32_t* idx_row = idx_b + static_cast<size_t>(i) * N;
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) {
      const int j = lane + 32 * u;
      if (j < N) {
        const int r = __ldg(idx_row + j);
        const float rel2 = to_f32(t2[(bh * N + i) * P + r]);
        const float rel3 = to_f32(t3[(bh * N + j) * P + r]);
        e[u] = (e[u] + rel2 + rel3) * scale + mask_add[j];
      } else {
        e[u] = -INFINITY;
      }
      m = fmaxf(m, e[u]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) {
      e[u] = (lane + 32 * u < N) ? expf(e[u] - m) : 0.f;
      s += e[u];
    }
    s = warp_sum(s);
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) {
      e[u] = e[u] / s;  // attn, f32
      dot += ga[u] * e[u];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) {
      const int j = lane + 32 * u;
      if (j < N) {
        attn[i * N + j] = e[u];
        ge[i * N + j] = e[u] * (ga[u] - dot) * scale;
      }
    }
  }
  __syncthreads();

  // pass 2: gq (one warp per query row), gk and gv (one warp per key
  // column), lanes across the head dimension
  for (int i = warp; i < N; i += kWarps) {
    float acc[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < N; ++j) {
      const float w = ge[i * N + j];
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh)
          acc[t] += w * to_f32(k[head + static_cast<size_t>(j) * Dh + d]);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) gq[head + static_cast<size_t>(i) * Dh + d] = acc[t];
    }
  }
  for (int j = warp; j < N; j += kWarps) {
    float ak[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
    float av[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < N; ++i) {
      const float w = ge[i * N + j];
      const float p = attn[i * N + j];
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) {
          const size_t o = head + static_cast<size_t>(i) * Dh + d;
          ak[t] += w * to_f32(q[o]);
          av[t] += p * to_f32(g[o]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        gk[head + static_cast<size_t>(j) * Dh + d] = ak[t];
        gv[head + static_cast<size_t>(j) * Dh + d] = av[t];
      }
    }
  }

  // pass 3: the dense table gradients, one warp per row: g_t2's row (b, i,
  // h) walks row i of ge in row_order; g_t3's row (b, j, h) walks column j
  // in col_order
  for (int r = warp; r < 2 * N; r += kWarps) {
    const int x = r < N ? r : r - N;
    const size_t out_row = ((static_cast<size_t>(b) * N + x) * H + h) * P;
    const int32_t* ord =
        (r < N ? row_order : col_order) + (static_cast<size_t>(b) * N + x) * N;
    int* sk = skeys + warp * N;
    float* sv = svals + warp * N;
    if (r < N)
      scatter_row<T>(gt2 + out_row, P, ord, idx_b + x * N, 1, ge + x * N, 1,
                     N, lane, sk, sv);
    else
      scatter_row<T>(gt3 + out_row, P, ord, idx_b + x, N, ge + x, N, N,
                     lane, sk, sv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           const void* t2, const void* t3, const void* idx, const void* mask,
           const void* row_order, const void* col_order, void* gq, void* gk,
           void* gv, void* gt2, void* gt3, int B, int H, int N, int Dh, int P,
           float scale, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(N) * N + 2 * static_cast<size_t>(Dh) * N + N +
       2 * static_cast<size_t>(kWarps) * N) *
      sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      rel_attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  rel_attn_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const T*>(t2), static_cast<const T*>(t3),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(row_order),
      static_cast<const int32_t*>(col_order), static_cast<float*>(gq),
      static_cast<float*>(gk), static_cast<float*>(gv), static_cast<T*>(gt2),
      static_cast<T*>(gt3), H, N, Dh, P, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, g, the tables and the table
// gradients). All tensors contiguous on one device: q, k, v, g [B, H, N, Dh];
// t2, t3 [B, H, N, P]; idx [B, N, N] int32 bank rows in [0, P); mask [B, N]
// bytes; row_order [B, N, N] int32 (each row of idx argsorted, stable);
// col_order [B, N, N] int32 (each column of idx, i.e. each row of idx^T,
// argsorted, stable); outputs gq, gk, gv [B, H, N, Dh] float32 and gt2, gt3
// [B, N, H, P]. Returns the CUDA error code of the launch (0 = launched).
extern "C" int gtos_rel_attn_bwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* g, const void* t2,
                                 const void* t3, const void* idx,
                                 const void* mask, const void* row_order,
                                 const void* col_order, void* gq, void* gk,
                                 void* gv, void* gt2, void* gt3, int B, int H,
                                 int N, int Dh, int P, float scale,
                                 void* stream) {
  if (N < 1 || N > kMaxN || Dh < 1 || Dh > 32 * kMaxDPL || B < 1 || H < 1 ||
      P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, t2, t3, idx, mask, row_order, col_order,
                         gq, gk, gv, gt2, gt3, B, H, N, Dh, P, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, t2, t3, idx, mask, row_order,
                                 col_order, gq, gk, gv, gt2, gt3, B, H, N, Dh,
                                 P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
