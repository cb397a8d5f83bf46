// Block-sparse relation-aware attention, forward, for Hopper (sm_90a): one
// kernel, with an optional pair of outputs for the softmax statistics.
//
// Replaces: gtos_tpu/ops/pallas/block_sparse_attention.py
//   B5  `_kernel`        (wrapper `block_sparse_attention`): the output;
//   B5s `_kernel_stats`  (wrapper `block_sparse_attention_with_stats`): the
//       output and the per-node softmax statistics (m, l) that the backward
//       recomputes the probabilities from.
//
// The kept pairs come from the tile layout of ops/block_sparse.py: for dst
// node i of graph b (tile td = i / 128, row il = i % 128) and each slot s
// with src tile ts = tile_src[b, td, s] >= 0, the pair (i, j = ts*128 + jl)
// is kept when r = tile_rel[b, td, s, il, jl] is a bank row (0 <= r < P)
// and j < N. For head h, with t4 [P, H] f32 holding a_r.b_r summed in f32
// and rounded to the bank type (the TPU kernel folds it into a padding lane
// of b_bank, block_sparse_attention.py:185; the wrapper computes it once):
//   e_ij  = (q_i.k_j + q_i.b_r + t4_r + k_j.a_r) * scale      (f32)
//   out_i = sum_j softmax_j(e_ij) v_j over the kept pairs of row i, 0 for a
//           row with none; the probabilities rounded to v's type before the
//           product, as the TPU kernel's p.astype(v.dtype), sums in f32;
//   m_i   = max_j e_ij (-1e9 without a kept pair), l_i = sum_j exp(e_ij-m_i).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): per
// kept pair and head about 5 Dh multiply-adds, against the bytes of q, k,
// v, out, the tile planes and the bank rows the kept pairs reference: the
// bytes bound it, most of them the bank rows (8-16k rows at c5's khop 4).
//
// Design: the TPU kernel keeps both banks resident in VMEM and builds the
// relation terms of a 128x128 block from P/128 bank-chunk matmuls, because
// Mosaic's gather is a shuffle inside one vector register; at P = 16384
// that is 128 chunks per block and head. A GPU thread can load any
// address, so here a pair reads only its own rows: no resident bank, no
// table. One warp per dst node, eight per block (grid: node groups x heads
// x graphs, 1024 blocks at every c5 shape). The warp walks its tile's slots
// and the node's row of each block, compacts the kept pairs (a ballot) into
// a small buffer in shared memory, and takes them 32 at a time: each lane
// scores one pair, reading k_j, a_r and b_r through L1/L2 16 bytes at a time
// against the node's q row staged in shared memory; the online softmax
// (running max and sum, f32) rescales the output, whose lanes run across
// the head dimension and read each pair's v row coalesced. Nodes past N
// (the padding of the last tile) are never read or written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarps = 8;           // dst nodes per block
constexpr int kMaxDh = 128;
constexpr int kMaxDPL = kMaxDh / 32;  // head dims per lane
constexpr int kBuf = 64;            // compacted pairs per warp (< 32 + 32)

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

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

// e_ij * (1/scale) of one pair: q_i from shared memory (f32), k_j, a_r, b_r
// rows from device memory, t4_r given
template <typename T>
__device__ __forceinline__ float pair_logit(const float* __restrict__ qs,
                                            const T* __restrict__ krow,
                                            const T* __restrict__ arow,
                                            const T* __restrict__ brow,
                                            float t4, int Dh) {
  float t1 = 0.f, qb = 0.f, ka = 0.f;
  for (int d0 = 0; d0 < Dh; d0 += 8) {
    float kr[8], ar[8], br[8];
    load8(krow + d0, kr);
    load8(arow + d0, ar);
    load8(brow + d0, br);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float qd = qs[d0 + c];
      t1 += qd * kr[c];
      qb += qd * br[c];
      ka += kr[c] * ar[c];
    }
  }
  return t1 + qb + t4 + ka;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blk_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ a_bank,
                    const T* __restrict__ b_bank,
                    const float* __restrict__ t4,
                    const int32_t* __restrict__ tile_src,
                    const int32_t* __restrict__ tile_rel,
                    T* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int H, int N, int Dh, int P,
                    int Td, int Smax, float scale) {
  __shared__ __align__(16) float qs_all[kWarps][kMaxDh];
  __shared__ int buf_j[kWarps][kBuf];
  __shared__ int buf_r[kWarps][kBuf];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;  // no block-wide barrier in this kernel
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = bh * N * Dh;
  float* qs = qs_all[warp];
  int* bj = buf_j[warp];
  int* br = buf_r[warp];
  for (int d = lane; d < Dh; d += 32)
    qs[d] = to_f32(q[head + static_cast<size_t>(i) * Dh + d]);
  __syncwarp();

  const int td = i / kTile, il = i - td * kTile;
  const size_t tile_row = static_cast<size_t>(b) * Td + td;
  const unsigned lt = (1u << lane) - 1u;
  float m = -INFINITY, l = 0.f;
  float acc[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
  int cnt = 0;

  // the online softmax over `n` compacted pairs at the buffer's front
  auto take = [&](int n) {
    int j = 0, r = 0;
    float e = -INFINITY;
    if (lane < n) {
      j = bj[lane];
      r = br[lane];
      const size_t row = (static_cast<size_t>(r) * H + h) * Dh;
      e = pair_logit<T>(qs, k + head + static_cast<size_t>(j) * Dh,
                        a_bank + row, b_bank + row,
                        __ldg(t4 + static_cast<size_t>(r) * H + h), Dh) *
          scale;
    }
    const float m_new = fmaxf(m, warp_max(e));
    const float alpha = expf(m - m_new);  // 0 on the first chunk
    const float p = lane < n ? expf(e - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    const float pr = round_to<T>(p);
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) acc[t] *= alpha;
    for (int c = 0; c < n; ++c) {
      const float pc = __shfl_sync(0xffffffffu, pr, c);
      const int jc = __shfl_sync(0xffffffffu, j, c);
      const T* vrow = v + head + static_cast<size_t>(jc) * Dh;
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) acc[t] += pc * to_f32(vrow[d]);
      }
    }
    m = m_new;
  };

  for (int s = 0; s < Smax; ++s) {
    const int ts = __ldg(tile_src + tile_row * Smax + s);
    if (ts < 0) continue;
    const int32_t* rel_row =
        tile_rel + ((tile_row * Smax + s) * kTile + il) * kTile;
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int jl = lane + 32 * u;
      const int r = __ldg(rel_row + jl);
      const int j = ts * kTile + jl;
      const bool keep = r >= 0 && r < P && j < N;
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int pos = cnt + __popc(mask & lt);
        bj[pos] = j;
        br[pos] = r;
      }
      cnt += __popc(mask);
      __syncwarp();
      if (cnt >= 32) {
        take(32);
        __syncwarp();
        cnt -= 32;
        if (lane < cnt) {
          bj[lane] = bj[32 + lane];
          br[lane] = br[32 + lane];
        }
        __syncwarp();
      }
    }
  }
  if (cnt > 0) take(cnt);

  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int t = 0; t < kMaxDPL; ++t) {
    const int d = lane + 32 * t;
    if (d < Dh)
      out[head + static_cast<size_t>(i) * Dh + d] =
          from_f32<T>(l > 0.f ? acc[t] * inv : 0.f);
  }
  if (m_out != nullptr && lane == 0) {
    m_out[bh * N + i] = l > 0.f ? m : -1e9f;
    l_out[bh * N + i] = l;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* a_bank,
           const void* b_bank, const void* t4, const void* tile_src,
           const void* tile_rel,
           void* out, void* m_out, void* l_out, int B, int H, int N, int Dh,
           int P, int Td, int Smax, float scale, cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, H, B);
  blk_attn_fwd_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(a_bank),
      static_cast<const T*>(b_bank), static_cast<const float*>(t4),
      static_cast<const int32_t*>(tile_src),
      static_cast<const int32_t*>(tile_rel), static_cast<T*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), H, N, Dh, P,
      Td, Smax, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the banks and out). All
// tensors contiguous on one device: q, k, v, out [B, H, N, Dh]; a_bank,
// b_bank [P, H, Dh] (16-byte aligned); t4 [P, H] float32; tile_src
// [B, Td, Smax] int32 (-1 = empty slot); tile_rel [B, Td, Smax, 128, 128]
// int32 (-1 = dropped pair), N <= Td * 128; m_out, l_out [B, H, N]
// float32, or both null for B5. Dh a multiple of 8, at most 128. Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int gtos_blk_attn_fwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* a_bank,
                                 const void* b_bank, const void* t4,
                                 const void* tile_src,
                                 const void* tile_rel, void* out, void* m_out,
                                 void* l_out, int B, int H, int N, int Dh,
                                 int P, int Td, int Smax, float scale,
                                 void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > Td * kTile || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0 || P < 1 || Smax < 1 ||
      (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, a_bank, b_bank, t4, tile_src, tile_rel, out,
                         m_out, l_out, B, H, N, Dh, P, Td, Smax, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, a_bank, b_bank, t4, tile_src,
                                 tile_rel, out, m_out, l_out, B, H, N, Dh, P,
                                 Td, Smax, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
