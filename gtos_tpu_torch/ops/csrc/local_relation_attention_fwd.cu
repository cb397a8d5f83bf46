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
//   p_ij  = softmax_j(e_ij) in f32 (two passes: the row's max, then the
//           sum of exp(e - max)), then rounded to the input type
//   out_i = sum_j p_ij v_j, accumulated in f32, stored in the input type
// (q_i + a_r).(k_j + b_r) is the TPU kernel's four-term score
// q.k + q.b_r + a_r.k + a_r.b_r, written as one product per pair.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): the work is
// 2*N*N*Dh multiply-adds per (graph, head), a few hundred MFLOP per batch,
// so the bytes bound it. Most of them are the rows of a_loc/b_loc that the
// graph references, then q/k/v/out ([B, H, N, Dh]) and idx ([B, N, N]
// int32); the least time is those bytes over 3.35 TB/s.
//
// Design: the TPU kernel builds per-head [N, P_loc] tables (q.b_loc^T,
// k.a_loc^T) on its matrix unit and gathers them 128 lanes at a time;
// here P_loc is 4-20x N, so the tables hold many more entries than there
// are pairs, and a GPU thread can load any address. So each pair reads its
// bank rows a_r, b_r directly, through L1 and L2, and the design keeps many
// of those reads in flight and reads each once for all heads (the skeleton
// of the block-sparse B5/B6, csrc/block_sparse_common.cuh):
//   - a block per (graph, query row i) and up to 8 heads, a warp a head;
//     the block stages row i's N slots and the key mask once for its
//     heads, so each pair's all-heads bank rows a_r, b_r (H*Dh values, one
//     row of the per-graph banks) are read by the block's warps together;
//   - a warp takes the keys in rounds: 4 groups of 8 lanes, each group
//     kGu pairs, each lane reading its 16-byte chunks of k_j, a_r and b_r
//     at once (Dh = 64 is one chunk a lane), so a round of 4 kGu pairs is
//     one round trip; the group adds its lanes' parts in 3 shuffles;
//   - the N scores of each head stay in shared memory (N <= 128), so the
//     softmax is the exact two-pass one; the probabilities, rounded to the
//     input type, then weight v_j in the same rounds, each group summing
//     its own keys, and the 4 groups' sums add in a fixed butterfly.
// k and v are read from L1/L2 by each row's block. Staging a head group's
// k and v in shared memory for 1, 2 or 4 rows a block, and 1 or 4 pairs a
// group a round, were measured slower on the H100 (PERF.md, Findings).
// The banks are taken as strided views: row stride `bank_stride` elements
// (2*H*Dh for the halves of the layer's [B, P_loc, 2*H*Dh] projection).

#include <math.h>

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kMaxN = 128;      // node bucket limit (as the TPU kernel)
constexpr int kHeads = 8;       // head warps a block
constexpr int kGl = kPairLanes; // lanes a pair
constexpr int kGroups = 32 / kGl;

template <typename T> struct FwdArgs {
  const T* q; const T* k; const T* v; const T* a_loc; const T* b_loc;
  const int32_t* idx; const uint8_t* mask;
  T* out; float* probs;
  long long bank_stride;    // elements between two rows of a_loc / b_loc
  int H, N, Dh, P;
  float scale;
  bool vec;                 // Dh % 8 == 0 and every row 16-byte aligned
};

// Query row blockIdx.x of graph blockIdx.z, warp w the head
// blockIdx.y * 8 + w; a lane holds kCpl chunks of a row (Dh up to 64 kCpl),
// a group kGu pairs a round.
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
local_fwd(const FwdArgs<T> a) {
  __shared__ int s_r[kMaxN];               // row i's slots
  __shared__ float s_mask[kMaxN];          // 0 or -1e9 per key
  __shared__ float s_e[kHeads][kMaxN];     // scores, then probabilities

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int i = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh;
  const int h = blockIdx.y * kHeads + warp;
  const int C = (Dh + 7) / 8;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    s_r[j] = __ldg(a.idx + (static_cast<size_t>(b) * N + i) * N + j);
    s_mask[j] = a.mask[static_cast<size_t>(b) * N + j] ? 0.f : -1e9f;
  }
  __syncthreads();
  if (h >= H) return;  // no block-wide barrier follows

  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
  const size_t own = head + static_cast<size_t>(i) * Dh;
  const size_t bank = static_cast<size_t>(b) * a.P * a.bank_stride +
                      static_cast<size_t>(h) * Dh;
  Chunk<T> qc[kCpl];
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    const int c = li + kGl * cc;
    if (c < C) load_chunk_n(a.q + own + c * 8, Dh - c * 8, a.vec, qc[cc]);
  }
  float* e_row = s_e[warp];

  // scores, kGroups * kGu keys a round
  for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
    Chunk<T> kc[kGu][kCpl], ac[kGu][kCpl], bc[kGu][kCpl];
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int j = j0 + grp + kGroups * uu;
      if (j < N) {
        const size_t krow = head + static_cast<size_t>(j) * Dh;
        const size_t row = bank + static_cast<size_t>(s_r[j]) * a.bank_stride;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C) {
            load_chunk_n(a.k + krow + c * 8, Dh - c * 8, a.vec, kc[uu][cc]);
            load_chunk_n(a.a_loc + row + c * 8, Dh - c * 8, a.vec,
                         ac[uu][cc]);
            load_chunk_n(a.b_loc + row + c * 8, Dh - c * 8, a.vec,
                         bc[uu][cc]);
          }
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int j = j0 + grp + kGroups * uu;
      float s = 0.f;
      if (j < N) {
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float q8[8], k8[8], a8[8], b8[8];
            unpack(qc[cc], q8);
            unpack(kc[uu][cc], k8);
            unpack(ac[uu][cc], a8);
            unpack(bc[uu][cc], b8);
#pragma unroll
            for (int e = 0; e < 8; ++e) s += (q8[e] + a8[e]) * (k8[e] + b8[e]);
          }
        }
      }
      s = group_sum(s);
      if (j < N && li == 0) e_row[j] = s * a.scale + s_mask[j];
    }
  }
  __syncwarp();

  // the exact two-pass softmax over the row's N scores, lanes across keys
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, e_row[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float p = expf(e_row[j] - m);
    e_row[j] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  float* prob_row =
      a.probs == nullptr
          ? nullptr
          : a.probs + ((static_cast<size_t>(b) * H + h) * N + i) * N;
  for (int j = lane; j < N; j += 32) {
    const float p = e_row[j] / sum;
    if (prob_row != nullptr) prob_row[j] = p;  // f32, before rounding
    e_row[j] = round_to<T>(p);                 // attn in the input type
  }
  __syncwarp();

  // out_i = sum_j p_ij v_j: each group its own keys, in the same rounds
  float acc[kCpl * 8];
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) acc[x] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
    Chunk<T> vc[kGu][kCpl];
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int j = j0 + grp + kGroups * uu;
      if (j < N) {
        const size_t vrow = head + static_cast<size_t>(j) * Dh;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C)
            load_chunk_n(a.v + vrow + c * 8, Dh - c * 8, a.vec, vc[uu][cc]);
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int j = j0 + grp + kGroups * uu;
      if (j < N) {
        const float p = e_row[j];
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float v8[8];
            unpack(vc[uu][cc], v8);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[cc * 8 + e] += p * v8[e];
          }
        }
      }
    }
  }
  // the 4 groups' sums, in a fixed butterfly; group 0 writes the row
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) {
#pragma unroll
    for (int off = kGl; off < 32; off <<= 1)
      acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], off);
  }
  if (grp == 0) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) store_n(a.out + own + c * 8, acc + cc * 8, Dh - c * 8, a.vec);
    }
  }
}

template <typename T, int kCpl, int kGu>
int launch_one(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid(a.N, (a.H + kHeads - 1) / kHeads, B);
  const int threads = 32 * (a.H < kHeads ? a.H : kHeads);
  local_fwd<T, kCpl, kGu><<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. On one device: q, k, v, out [B, H, N,
// Dh] contiguous; a_loc, b_loc [B, P_loc, H, Dh] with the last two
// dimensions contiguous, `bank_stride` elements between two rows and
// P_loc * bank_stride between two graphs (a view of one half of a [B,
// P_loc, 2*H*Dh] tensor has bank_stride 2*H*Dh); idx [B, N, N] int32 slots
// in [0, P_loc); mask [B, N] bytes (nonzero = real node); probs [B, H, N,
// N] f32, or null for none. Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int gtos_local_rel_attn_fwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* a_loc, const void* b_loc,
                                       long long bank_stride,
                                       const void* idx, const void* mask,
                                       void* out, void* probs, int B, int H,
                                       int N, int Dh, int P_loc, float scale,
                                       void* stream) {
  if (N < 1 || N > kMaxN || Dh < 1 || Dh > kMaxDh || B < 1 || H < 1 ||
      P_loc < 1 || bank_stride < static_cast<long long>(H) * Dh)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Dh % 8 == 0 && bank_stride % 8 == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(a_loc) &&
                   aligned16(b_loc) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const FwdArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(a_loc),
        static_cast<const T*>(b_loc), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(mask), static_cast<T*>(out),
        static_cast<float*>(probs), bank_stride, H, N, Dh, P_loc, scale,
        vec};
    return a.Dh > 64 ? launch_one<T, 2, 1>(a, B, s)
                     : launch_one<T, 1, 2>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}
