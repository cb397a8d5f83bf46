// Localized relation-aware graph attention, forward, for Hopper (sm_90a).
//
// Replaces: gtos_tpu/ops/pallas/local_relation_attention.py `_fwd_kernel`
// (the Pallas TPU kernel behind `local_relation_attention`), both without
// probs (B1, serving) and with them (B1p, `with_probs=True`, the forward of
// a training step: a non-null `probs` pointer receives the f32
// probabilities [B, H, N, N] before they are rounded to the input type).
//
// Computes, for graph b, head h, query node i, key node j, r = idx[b,i,j]:
//   e_ij  = scale * (q_i + a_r) . (k_j + b_r) + (mask[b,j] ? 0 : -1e9)
//   p_ij  = softmax_j(e_ij) in f32, then rounded to the input type
//   out_i = sum_j p_ij v_j, accumulated in f32, stored in the input type
// (q_i + a_r).(k_j + b_r) is the TPU kernel's four-term score
// q.k + q.b_r + a_r.k + a_r.b_r, written as one product per pair.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): the work is
// 2*N*N*Dh multiply-adds per (graph, head), a few hundred MFLOP per batch,
// so the bytes bound it. Most of them are the rows of a_loc/b_loc
// ([B, P_loc, H, Dh]) that the graph references, then q/k/v/out
// ([B, H, N, Dh]) and idx ([B, N, N] int32); the least time is those
// bytes over 3.35 TB/s.
//
// Design: the TPU kernel builds [N, P_loc] tables (q.b_loc^T, k.a_loc^T)
// and gathers them 128 lanes at a time because Mosaic's gather is a
// shuffle within one vector register. A GPU thread can load any address,
// so this kernel reads each pair's bank rows a_r, b_r directly, through
// the L1 and L2 caches: the N*N pairs and H heads of one graph reuse the
// same few hundred rows, so device memory sees each referenced row about
// once, which is the bound above. The direct form does 2*N*N*Dh work per
// head, never more than the tables' 2*N*P_loc*Dh since P_loc >= 128 >= N,
// and needs neither the t4 = a.b precompute nor the TPU's operand packing.
// One block per (graph, head, 8 query rows), k and v of that (graph, head)
// staged in shared memory; one warp per query row, its lanes across the
// head dimension for the scores and the output and across keys for the
// softmax. Scores, softmax and the output sum are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // query rows per block
constexpr int kMaxN = 128;   // node bucket limit (as the TPU kernel)
constexpr int kMaxDPL = 4;   // head dims per lane: Dh <= 128

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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
local_rel_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ a_loc,
                          const T* __restrict__ b_loc,
                          const int32_t* __restrict__ idx,
                          const uint8_t* __restrict__ mask,
                          T* __restrict__ out, float* __restrict__ probs,
                          int H, int N, int Dh, int P_loc, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                    // [N][Dh]
  T* vs = ks + N * Dh;                                   // [N][Dh]
  float* scores = reinterpret_cast<float*>(vs + N * Dh); // [kWarps][N]
  float* mask_add = scores + kWarps * N;                 // [N]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;

  for (int e = threadIdx.x; e < N * Dh; e += blockDim.x) {
    ks[e] = k[head + e];
    vs[e] = v[head + e];
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    mask_add[j] = mask[static_cast<size_t>(b) * N + j] ? 0.f : -1e9f;
  __syncthreads();

  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;  // no block-wide barrier follows

  float qv[kMaxDPL];
#pragma unroll
  for (int t = 0; t < kMaxDPL; ++t) {
    const int d = lane + 32 * t;
    qv[t] = d < Dh ? to_f32(q[head + static_cast<size_t>(i) * Dh + d]) : 0.f;
  }
  const int32_t* idx_row = idx + (static_cast<size_t>(b) * N + i) * N;
  const size_t row_stride = static_cast<size_t>(H) * Dh;
  const T* a_head = a_loc + static_cast<size_t>(b) * P_loc * row_stride +
                    static_cast<size_t>(h) * Dh;
  const T* b_head = b_loc + static_cast<size_t>(b) * P_loc * row_stride +
                    static_cast<size_t>(h) * Dh;
  float* row = scores + warp * N;

  for (int j = 0; j < N; ++j) {
    const size_t r = static_cast<size_t>(__ldg(idx_row + j)) * row_stride;
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh)
        part += (qv[t] + to_f32(a_head[r + d])) *
                (to_f32(ks[j * Dh + d]) + to_f32(b_head[r + d]));
    }
    part = warp_sum(part);
    if (lane == 0) row[j] = part * scale + mask_add[j];
  }
  __syncwarp();

  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float p = expf(row[j] - m);
    row[j] = p;
    s += p;
  }
  s = warp_sum(s);
  float* prob_row =
      probs == nullptr
          ? nullptr
          : probs + ((static_cast<size_t>(b) * H + h) * N + i) * N;
  for (int j = lane; j < N; j += 32) {
    const float p = row[j] / s;
    if (prob_row != nullptr) prob_row[j] = p;  // f32, before rounding
    row[j] = to_f32(from_f32<T>(p));           // attn in the input type
  }
  __syncwarp();

#pragma unroll
  for (int t = 0; t < kMaxDPL; ++t) {
    const int d = lane + 32 * t;
    if (d < Dh) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += row[j] * to_f32(vs[j * Dh + d]);
      out[head + static_cast<size_t>(i) * Dh + d] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* a_loc,
           const void* b_loc, const void* idx, const void* mask, void* out,
           void* probs, int B, int H, int N, int Dh, int P_loc, float scale,
           cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(N) * Dh * sizeof(T) +
                      static_cast<size_t>(kWarps + 1) * N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_rel_attn_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kWarps - 1) / kWarps, H, B);
  local_rel_attn_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(a_loc),
      static_cast<const T*>(b_loc), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      static_cast<float*>(probs), H, N, Dh, P_loc, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous on one device:
// q, k, v, out [B, H, N, Dh]; a_loc, b_loc [B, P_loc, H, Dh]; idx [B, N, N]
// int32 slots in [0, P_loc); mask [B, N] bytes (nonzero = real node);
// probs [B, H, N, N] f32, or null for none. Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int gtos_local_rel_attn_fwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* a_loc, const void* b_loc,
                                       const void* idx, const void* mask,
                                       void* out, void* probs, int B, int H,
                                       int N, int Dh, int P_loc, float scale,
                                       void* stream) {
  if (N < 1 || N > kMaxN || Dh < 1 || Dh > 32 * kMaxDPL || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, a_loc, b_loc, idx, mask, out, probs, B, H,
                         N, Dh, P_loc, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, a_loc, b_loc, idx, mask, out,
                                 probs, B, H, N, Dh, P_loc, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
