// Relation-aware graph attention over the batch-global relation bank,
// forward, for Hopper (sm_90a): two kernels with one body.
//
// Replaces: gtos_tpu/ops/pallas/relation_attention.py
//   B3  `_kernel`         (wrapper `fused_relation_attention`): the score
//       terms come from precomputed tables t2 = q.b_bank^T + t4 and
//       t3 = k.a_bank^T, [B, H, N, P] in the input type;
//   B3' `_kernel_inline`  (wrapper `fused_relation_attention_inline`): the
//       same function from the banks a_bank/b_bank [P, H, Dh] themselves,
//       no table in device memory.
//
// Computes, for graph b, head h, query node i, key node j, r = idx[b,i,j]:
//   e_ij  = (q_i.k_j + T2(i, r) + T3(j, r)) * scale + (mask[b,j] ? 0 : -1e9)
//   p_ij  = softmax_j(e_ij) in f32, then rounded to the input type
//   out_i = sum_j p_ij v_j, accumulated in f32, stored in the input type
// with T2(i, r) = t2[b,h,i,r], T3(j, r) = t3[b,h,j,r] for B3, and for B3'
// T2(i, r) = q_i.b_r + t4[r,h], T3(j, r) = k_j.a_r, every product summed in
// f32; t4 [P, H] f32 holds a_r.b_r rounded to the bank type, as the TPU
// kernel folds it into a padding lane of b_bank (relation_attention.py:282).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): a few
// hundred MFLOP per batch against the bytes of q, k, v, out, idx, and of
// the table entries (B3) or bank rows (B3') that the pairs reference: the
// bytes bound both.
//
// Design: the TPU kernels stream whole [N, P] table planes (or build them
// chunk by chunk from VMEM-resident banks) because Mosaic's gather is a
// shuffle inside one vector register. A GPU thread can load any address,
// so here each pair reads only what it needs: two table entries (B3), or
// the bank rows a_r and b_r through the L1/L2 caches, 16 bytes at a time
// (B3'). One block per (graph, head, 8 query rows); k (transposed, f32)
// and v of that (graph, head) staged in shared memory; one warp per query
// row with its lanes across keys for the scores and the softmax, and
// across the head dimension for the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // query rows per block
constexpr int kMaxN = 128;            // node bucket limit (as the TPU kernel)
constexpr int kMaxJPL = kMaxN / 32;   // keys per lane
constexpr int kMaxDPL = 4;            // head dims per lane: Dh <= 128

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

// 8 consecutive elements (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = __bfloat1622float2(h[c]);
    o[2 * c] = f.x;
    o[2 * c + 1] = f.y;
  }
}

template <typename T, bool kInline>
__global__ void __launch_bounds__(kWarps * 32)
rel_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ t2,
                    const T* __restrict__ t3, const T* __restrict__ a_bank,
                    const T* __restrict__ b_bank,
                    const float* __restrict__ t4,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    int H, int N, int Dh, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* kT = reinterpret_cast<float*>(smem);   // [Dh][N]
  float* qs = kT + Dh * N;                      // [kWarps][Dh]
  float* rows = qs + kWarps * Dh;               // [kWarps][N]
  float* mask_add = rows + kWarps * N;          // [N]
  T* vs = reinterpret_cast<T*>(mask_add + N);   // [N][Dh]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = bh * N * Dh;
  const int i = blockIdx.x * kWarps + warp;

  for (int e = threadIdx.x; e < N * Dh; e += blockDim.x) {
    const int j = e / Dh;
    kT[(e - j * Dh) * N + j] = to_f32(k[head + e]);
    vs[e] = v[head + e];
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    mask_add[j] = mask[static_cast<size_t>(b) * N + j] ? 0.f : -1e9f;
  if (i < N)
    for (int d = lane; d < Dh; d += 32)
      qs[warp * Dh + d] = to_f32(q[head + static_cast<size_t>(i) * Dh + d]);
  __syncthreads();
  if (i >= N) return;  // no block-wide barrier follows

  const float* qi = qs + warp * Dh;
  const int32_t* idx_row = idx + (static_cast<size_t>(b) * N + i) * N;
  const int nj = (N + 31) / 32;
  float e[kMaxJPL];
#pragma unroll
  for (int u = 0; u < kMaxJPL; ++u) {
    e[u] = -INFINITY;
    const int j = lane + 32 * u;
    if (u >= nj || j >= N) continue;
    const int r = __ldg(idx_row + j);
    float t1 = 0.f, rel2, rel3;
    if constexpr (kInline) {
      const size_t row = (static_cast<size_t>(r) * H + h) * Dh;
      float qb = 0.f, ka = 0.f;
      for (int d0 = 0; d0 < Dh; d0 += 8) {
        float br[8], ar[8];
        load8(b_bank + row + d0, br);
        load8(a_bank + row + d0, ar);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float qd = qi[d0 + c];
          const float kd = kT[(d0 + c) * N + j];
          t1 += qd * kd;
          qb += qd * br[c];
          ka += kd * ar[c];
        }
      }
      rel2 = qb + t4[static_cast<size_t>(r) * H + h];
      rel3 = ka;
    } else {
      for (int d = 0; d < Dh; ++d) t1 += qi[d] * kT[d * N + j];
      rel2 = to_f32(t2[(bh * N + i) * P + r]);
      rel3 = to_f32(t3[(bh * N + j) * P + r]);
    }
    e[u] = (t1 + rel2 + rel3) * scale + mask_add[j];
  }

  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < kMaxJPL; ++u) m = fmaxf(m, e[u]);
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxJPL; ++u) {
    e[u] = (lane + 32 * u < N) ? expf(e[u] - m) : 0.f;
    s += e[u];
  }
  s = warp_sum(s);
  float* row = rows + warp * N;
#pragma unroll
  for (int u = 0; u < kMaxJPL; ++u) {
    const int j = lane + 32 * u;
    if (j < N) row[j] = to_f32(from_f32<T>(e[u] / s));  // attn, input type
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

template <typename T, bool kInline>
int launch(const void* q, const void* k, const void* v, const void* t2,
           const void* t3, const void* a_bank, const void* b_bank,
           const void* t4, const void* idx, const void* mask, void* out,
           int B, int H, int N, int Dh, int P, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(Dh) * N + kWarps * Dh + kWarps * N + N) *
          sizeof(float) +
      static_cast<size_t>(N) * Dh * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      rel_attn_fwd_kernel<T, kInline>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kWarps - 1) / kWarps, H, B);
  rel_attn_fwd_kernel<T, kInline><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(t2),
      static_cast<const T*>(t3), static_cast<const T*>(a_bank),
      static_cast<const T*>(b_bank), static_cast<const float*>(t4),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), H, N, Dh, P, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int B, int H, int N, int Dh, int P) {
  return N < 1 || N > kMaxN || Dh < 8 || Dh > 32 * kMaxDPL || Dh % 8 != 0 ||
         B < 1 || H < 1 || P < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the tables or banks, and
// out). All tensors contiguous on one device: q, k, v, out [B, H, N, Dh];
// idx [B, N, N] int32 bank rows in [0, P); mask [B, N] bytes (nonzero =
// real node). Dh a multiple of 8, at most 128; N at most 128. Each returns
// the CUDA error code of the launch (0 = launched).

// B3: t2, t3 [B, H, N, P].
extern "C" int gtos_rel_attn_fwd_tables(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* t2, const void* t3,
                                        const void* idx, const void* mask,
                                        void* out, int B, int H, int N,
                                        int Dh, int P, float scale,
                                        void* stream) {
  if (bad_sizes(B, H, N, Dh, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(q, k, v, t2, t3, nullptr, nullptr, nullptr,
                                idx, mask, out, B, H, N, Dh, P, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, t2, t3, nullptr, nullptr,
                                        nullptr, idx, mask, out, B, H, N, Dh,
                                        P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B3': a_bank, b_bank [P, H, Dh] (16-byte aligned); t4 [P, H] float32.
extern "C" int gtos_rel_attn_fwd_inline(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* a_bank,
                                        const void* b_bank, const void* t4,
                                        const void* idx, const void* mask,
                                        void* out, int B, int H, int N,
                                        int Dh, int P, float scale,
                                        void* stream) {
  if (bad_sizes(B, H, N, Dh, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(q, k, v, nullptr, nullptr, a_bank, b_bank, t4,
                               idx, mask, out, B, H, N, Dh, P, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k, v, nullptr, nullptr, a_bank,
                                       b_bank, t4, idx, mask, out, B, H, N,
                                       Dh, P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
