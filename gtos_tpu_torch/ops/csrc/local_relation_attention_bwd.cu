// Localized relation-aware graph attention, backward, for Hopper (sm_90a).
//
// Replaces: gtos_tpu/ops/pallas/local_relation_attention.py `_bwd_kernel`
// (with its helper `_sorted_scatter`; wrapper `local_relation_attention_bwd`).
//
// From the forward's f32 probabilities p [B, H, N, N] and an f32 cotangent
// g [B, H, N, Dh] of the output, for graph b, head h and r = idx[b, i, j]:
//   gv_j    = sum_i p_ij g_i
//   ge_ij   = scale * p_ij * (g_i . v_j - sum_j' p_ij' g_i . v_j')
//   gq_i    = sum_j ge_ij (k_j + b_r)        gk_j = sum_i ge_ij (q_i + a_r)
//   g_a[r]  = sum_{(i,j): idx=r} ge_ij (k_j + b_r)
//   g_b[r]  = sum_{(i,j): idx=r} ge_ij (q_i + a_r)
// (the TPU kernel's g_t2/g_t3 tables, their contractions and its fused t4
// unfold, written per pair), every sum in f32, outputs in the input type;
// every slot of g_a/g_b [B, P_loc, H, Dh] is written, zero where no pair
// refers to it, as the TPU kernel writes the dense bank gradients.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): a few
// multiply-adds per pair and head dimension, under a GFLOP per training
// batch, against the bytes of q, k, v, g, p, the referenced bank rows, idx
// and the dense g_a/g_b outputs: the bytes bound it.
//
// Design: the TPU kernel turns the two scatter-adds (pairs -> slots) into a
// sort, a triangular-matmul prefix sum and boundary gathers, because Mosaic
// has no scatter and its gather is a shuffle inside one vector register.
// A GPU block can instead own a whole (graph, head): one block per (b, h)
// computes ge [N, N] into shared memory, so the column sums gk and gv need
// neither atomics nor a second pass. The bank gradients are a slot-ordered
// walk over the pairs: `pair_order` [B, N*N] lists each graph's pairs
// (i*N + j) sorted by slot and `slot_start` [B, P_loc + 1] bounds each
// slot's run (built once per encoder stack on the card). One warp sums a
// slot's pairs in registers, lanes across the head dimension, and writes
// the slot once; a slot with more than kBigSlot pairs (the pad slot 0 of a
// graph much smaller than its node bucket) is cut into one contiguous part
// per warp and the parts are added in warp order. No atomics anywhere, so
// the result is the same bit for bit on every run. Shared memory holds ge
// and k in f32 and, in turn, v^T (score pass) and q (gradient pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 128;              // node bucket limit (as the TPU kernel)
constexpr int kMaxDPL = 4;              // head dims per lane: Dh <= 128
constexpr int kMaxJPL = kMaxN / 32;     // keys per lane in the score pass
constexpr int kBigSlot = 64;            // slots with more pairs are shared
constexpr int kMaxBig = kMaxN * kMaxN / (kBigSlot + 1) + 1;
constexpr int kMaxDynamicSmem = 232448 - 20 * 1024;  // 227 KB less static

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

// Sums of slot r's pairs ord[lo, hi) into sa (for g_a) and sb (for g_b);
// lanes across the head dimension.
__device__ __forceinline__ void slot_sums(
    const int32_t* __restrict__ ord, int lo, int hi, const float* ge,
    const float* ks, const float* qs, const float* a_r, const float* b_r,
    int N, int Dh, int lane, float* sa, float* sb) {
#pragma unroll
  for (int t = 0; t < kMaxDPL; ++t) sa[t] = sb[t] = 0.f;
  for (int p = lo; p < hi; ++p) {
    const int pair = __ldg(ord + p);
    const int i = pair / N;
    const int j = pair - i * N;
    const float e = ge[pair];
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        sa[t] += e * (ks[j * Dh + d] + b_r[t]);
        sb[t] += e * (qs[i * Dh + d] + a_r[t]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
local_rel_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ probs,
                          const T* __restrict__ a_loc,
                          const T* __restrict__ b_loc,
                          const int32_t* __restrict__ idx,
                          const int32_t* __restrict__ pair_order,
                          const int32_t* __restrict__ slot_start,
                          T* __restrict__ gq, T* __restrict__ gk,
                          T* __restrict__ gv, T* __restrict__ ga,
                          T* __restrict__ gb, int H, int N, int Dh,
                          int P_loc, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ge = reinterpret_cast<float*>(smem);  // [N][N]
  float* ks = ge + N * N;                       // [N][Dh]
  float* xs = ks + N * Dh;                      // [Dh][N] v^T, then [N][Dh] q
  __shared__ int n_big;
  __shared__ int big[kMaxBig];
  __shared__ float part[2][kWarps][32 * kMaxDPL];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
  const size_t pr_head = (static_cast<size_t>(b) * H + h) * N * N;
  const int32_t* idx_b = idx + static_cast<size_t>(b) * N * N;
  const int32_t* ord = pair_order + static_cast<size_t>(b) * N * N;
  const int32_t* st = slot_start + static_cast<size_t>(b) * (P_loc + 1);
  const size_t row_stride = static_cast<size_t>(H) * Dh;
  const size_t bank = static_cast<size_t>(b) * P_loc * row_stride +
                      static_cast<size_t>(h) * Dh;
  const T* a_head = a_loc + bank;
  const T* b_head = b_loc + bank;

  if (tid == 0) n_big = 0;
  for (int e = tid; e < N * Dh; e += kThreads) {
    const int j = e / Dh;
    ks[e] = to_f32(k[head + e]);
    xs[(e - j * Dh) * N + j] = to_f32(v[head + e]);
  }
  __syncthreads();
  // at most N*N / (kBigSlot + 1) < kMaxBig slots hold more than kBigSlot
  for (int r = tid; r < P_loc; r += kThreads)
    if (__ldg(st + r + 1) - __ldg(st + r) > kBigSlot)
      big[atomicAdd(&n_big, 1)] = r;

  // score pass: one warp per query row, lanes across keys
  for (int i = warp; i < N; i += kWarps) {
    float gr[kMaxDPL];
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      gr[t] = d < Dh ? __ldg(g + head + static_cast<size_t>(i) * Dh + d) : 0.f;
    }
    float acc[kMaxJPL];
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) acc[u] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      for (int dd = 0; dd < 32; ++dd) {
        const int d = 32 * t + dd;
        if (d >= Dh) break;  // the same for every lane
        const float gd = __shfl_sync(0xffffffffu, gr[t], dd);
#pragma unroll
        for (int u = 0; u < kMaxJPL; ++u) {
          const int j = lane + 32 * u;
          if (j < N) acc[u] += gd * xs[d * N + j];
        }
      }
    }
    float p[kMaxJPL];
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) {
      const int j = lane + 32 * u;
      p[u] = j < N ? __ldg(probs + pr_head + static_cast<size_t>(i) * N + j)
                   : 0.f;
      dot += p[u] * acc[u];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int u = 0; u < kMaxJPL; ++u) {
      const int j = lane + 32 * u;
      if (j < N) ge[i * N + j] = scale * p[u] * (acc[u] - dot);
    }
  }
  __syncthreads();  // ge complete, v^T no longer read
  for (int e = tid; e < N * Dh; e += kThreads) xs[e] = to_f32(q[head + e]);
  __syncthreads();
  const float* qs = xs;

  // gq: one warp per query row, lanes across the head dimension
  for (int i = warp; i < N; i += kWarps) {
    float acc[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < N; ++j) {
      const float e = ge[i * N + j];
      const size_t r = static_cast<size_t>(__ldg(idx_b + i * N + j)) *
                       row_stride;
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) acc[t] += e * (ks[j * Dh + d] + to_f32(b_head[r + d]));
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) gq[head + static_cast<size_t>(i) * Dh + d] = from_f32<T>(acc[t]);
    }
  }

  // gk and gv: one warp per key column
  for (int j = warp; j < N; j += kWarps) {
    float ak[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
    float av[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < N; ++i) {
      const float e = ge[i * N + j];
      const float p = __ldg(probs + pr_head + static_cast<size_t>(i) * N + j);
      const size_t r = static_cast<size_t>(__ldg(idx_b + i * N + j)) *
                       row_stride;
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) {
          ak[t] += e * (qs[i * Dh + d] + to_f32(a_head[r + d]));
          av[t] += p * __ldg(g + head + static_cast<size_t>(i) * Dh + d);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        gk[head + static_cast<size_t>(j) * Dh + d] = from_f32<T>(ak[t]);
        gv[head + static_cast<size_t>(j) * Dh + d] = from_f32<T>(av[t]);
      }
    }
  }

  // bank gradients, slot by slot: one warp per slot of at most kBigSlot
  // pairs (an empty slot writes zeros)
  float a_r[kMaxDPL], b_r[kMaxDPL], sa[kMaxDPL], sb[kMaxDPL];
  for (int r = warp; r < P_loc; r += kWarps) {
    const int s0 = __ldg(st + r);
    const int s1 = __ldg(st + r + 1);
    if (s1 - s0 > kBigSlot) continue;
    const size_t row = static_cast<size_t>(r) * row_stride;
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      a_r[t] = d < Dh ? to_f32(a_head[row + d]) : 0.f;
      b_r[t] = d < Dh ? to_f32(b_head[row + d]) : 0.f;
    }
    slot_sums(ord, s0, s1, ge, ks, qs, a_r, b_r, N, Dh, lane, sa, sb);
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        ga[bank + row + d] = from_f32<T>(sa[t]);
        gb[bank + row + d] = from_f32<T>(sb[t]);
      }
    }
  }
  // the slots with many pairs: every warp sums one contiguous part, then
  // the parts are added in warp order
  for (int n = 0; n < n_big; ++n) {
    const int r = big[n];
    const int s0 = __ldg(st + r);
    const int len = __ldg(st + r + 1) - s0;
    const size_t row = static_cast<size_t>(r) * row_stride;
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      a_r[t] = d < Dh ? to_f32(a_head[row + d]) : 0.f;
      b_r[t] = d < Dh ? to_f32(b_head[row + d]) : 0.f;
    }
    slot_sums(ord, s0 + len * warp / kWarps, s0 + len * (warp + 1) / kWarps,
              ge, ks, qs, a_r, b_r, N, Dh, lane, sa, sb);
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      part[0][warp][lane + 32 * t] = sa[t];
      part[1][warp][lane + 32 * t] = sb[t];
    }
    __syncthreads();
    if (tid < 2 * Dh) {
      const int which = tid < Dh ? 0 : 1;
      const int d = tid - which * Dh;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += part[which][w][d];
      (which == 0 ? ga : gb)[bank + row + d] = from_f32<T>(s);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           const void* probs, const void* a_loc, const void* b_loc,
           const void* idx, const void* pair_order, const void* slot_start,
           void* gq, void* gk, void* gv, void* ga, void* gb, int B, int H,
           int N, int Dh, int P_loc, float scale, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(N) * N + 2 * static_cast<size_t>(N) * Dh) *
      sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's static shared memory counts against the default 48 KB
  // too, so the dynamic size is always declared
  const cudaError_t err = cudaFuncSetAttribute(
      local_rel_attn_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  local_rel_attn_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const float*>(probs), static_cast<const T*>(a_loc),
      static_cast<const T*>(b_loc), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(pair_order),
      static_cast<const int32_t*>(slot_start), static_cast<T*>(gq),
      static_cast<T*>(gk), static_cast<T*>(gv), static_cast<T*>(ga),
      static_cast<T*>(gb), H, N, Dh, P_loc, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, a_loc, b_loc and every
// output). All tensors contiguous on one device: q, k, v and the outputs
// gq, gk, gv [B, H, N, Dh]; g [B, H, N, Dh] f32; probs [B, H, N, N] f32;
// a_loc, b_loc and the outputs ga, gb [B, P_loc, H, Dh]; idx [B, N, N]
// int32 slots in [0, P_loc); pair_order [B, N*N] int32 (each graph's i*N+j
// sorted by slot); slot_start [B, P_loc + 1] int32 (run bounds, last =
// N*N). Returns the CUDA error code of the launch (0 = launched).
extern "C" int gtos_local_rel_attn_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    const void* probs, const void* a_loc, const void* b_loc, const void* idx,
    const void* pair_order, const void* slot_start, void* gq, void* gk,
    void* gv, void* ga, void* gb, int B, int H, int N, int Dh, int P_loc,
    float scale, void* stream) {
  if (N < 1 || N > kMaxN || Dh < 1 || Dh > 32 * kMaxDPL || B < 1 || H < 1 ||
      P_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, probs, a_loc, b_loc, idx, pair_order,
                         slot_start, gq, gk, gv, ga, gb, B, H, N, Dh, P_loc,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, probs, a_loc, b_loc, idx,
                                 pair_order, slot_start, gq, gk, gv, ga, gb,
                                 B, H, N, Dh, P_loc, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
