// Relation-aware graph attention over the batch-global relation bank,
// forward, for Hopper (sm_90a): one kernel body for two entry points.
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
// with T2(i, r) = t2[b,h,i,r], T3(j, r) = t3[b,h,j,r] for B3 (read in the
// input type, widened to f32), and for B3' T2(i, r) = q_i.b_r + t4_r,
// T3(j, r) = k_j.a_r, every product summed in f32, where t4_r = a_r.b_r is
// summed in f32 and rounded to the bank type, as the TPU kernel folds it
// into a padding lane of b_bank (relation_attention.py:282).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): the
// bytes of q, k, v, out, idx and of the table entries (B3) or bank rows
// (B3') the pairs reference; what holds both above it is the latency of
// their gathers (B3: each table entry a scattered read of a 32-byte sector).
//
// Design. The TPU kernels stream whole [N, P] table planes (or build them
// from VMEM-resident banks), as Mosaic's gather is a shuffle inside one
// vector register; here each pair reads only what it needs, on the
// skeleton of the localized B1 (local_relation_attention_fwd.cu):
//   - a block per (graph, query row i) and up to 8 heads, a warp a head;
//     the block stages row i's N bank rows and the key mask once;
//   - B3 first issues its 2N table scalars a warp, lanes across keys
//     (t2[b,h,i,r_ij], one P-long row, and t3[b,h,j,r_ij]), independent
//     loads into registers that complete the scores in the softmax's
//     first pass;
//   - the q.k rounds: 4 groups of 8 lanes, a group kGu pairs a round, each
//     lane its 16-byte chunks of k_j (B3': and of the pair's all-heads bank
//     rows a_r, b_r, read by the block's warps together, and its part of
//     t4_r) against q_i's in registers, summed in 3 shuffles;
//   - the exact two-pass softmax over each head's N scores in shared
//     memory; p, rounded to v's type, weights v_j in the same rounds and
//     the 4 groups' sums add in a fixed butterfly.
// B3's earlier design (a block per 8 query rows of one head, k restaged
// transposed in shared memory by each block, a lane a key) was 20-58x its
// bound (PERF.md, Findings).

#include <math.h>

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kMaxN = 128;            // node bucket limit (as the TPU kernel)
constexpr int kKeys = kMaxN / 32;     // keys a lane in the softmax passes
constexpr int kHeads = 8;             // head warps a block
constexpr int kGl = kPairLanes;       // lanes a pair
constexpr int kGroups = 32 / kGl;

// where a pair's relation terms T2(i, r), T3(j, r) come from
enum class Rel { kTables, kBanks };

template <typename T> struct FwdArgs {
  const T* q; const T* k; const T* v;
  const T* t2; const T* t3;             // B3: [B, H, N, P]
  const T* a_bank; const T* b_bank;     // B3': [P, H, Dh] rows
  const int32_t* idx; const uint8_t* mask; T* out;
  long long P;              // B3: the tables' row length
  long long bank_stride;    // B3': elements between two rows of the banks
  int H, N, Dh;
  float scale;
};

// A lane's chunks of the rows of one round's keys j0 + grp + kGroups * uu
// (k_j or v_j of one head, `rows` its first row), kCpl chunks a row.
template <typename T, int kCpl, int kGu>
__device__ __forceinline__ void load_round(const T* rows, int j0, int N,
                                           int Dh, int grp, int li,
                                           Chunk<T> (&c)[kGu][kCpl]) {
#pragma unroll
  for (int uu = 0; uu < kGu; ++uu) {
    const int j = j0 + grp + kGroups * uu;
    if (j < N) {
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int x = li + kGl * cc;
        if (x < Dh / 8)
          load_chunk(rows + static_cast<size_t>(j) * Dh + x * 8, c[uu][cc]);
      }
    }
  }
}

// The body of both kernels: query row blockIdx.x of graph blockIdx.z,
// warp w the head blockIdx.y * 8 + w; a lane holds kCpl chunks of a row
// (Dh up to 64 kCpl), a group kGu pairs a round.
template <Rel kRel, typename T, int kCpl, int kGu>
__device__ __forceinline__ void fwd_row(const FwdArgs<T>& a) {
  constexpr bool kTables = kRel == Rel::kTables;
  __shared__ int s_r[kMaxN];               // row i's bank rows
  __shared__ float s_mask[kMaxN];          // 0 or -1e9 per key
  __shared__ float s_e[kHeads][kMaxN];     // scores, then probabilities
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int i = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, C = Dh / 8;
  const int h = blockIdx.y * kHeads + warp;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = bh * N * Dh;
  const size_t own = head + static_cast<size_t>(i) * Dh;
  const size_t bank = static_cast<size_t>(h) * Dh;
  Chunk<T> qc[kCpl];   // q_i, read with the row's bank rows
  if (h < H) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) load_chunk(a.q + own + c * 8, qc[cc]);
    }
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    s_r[j] = __ldg(a.idx + (static_cast<size_t>(b) * N + i) * N + j);
    s_mask[j] = a.mask[static_cast<size_t>(b) * N + j] ? 0.f : -1e9f;
  }
  __syncthreads();
  if (h >= H) return;  // no block-wide barrier follows

  float* e_row = s_e[warp];

  // B3's table terms of key lane + 32 u, issued before the rounds
  T x2[kKeys], x3[kKeys];
  if constexpr (kTables) {
    const T* t2_row = a.t2 + (bh * N + i) * a.P;
    const T* t3_head = a.t3 + bh * N * a.P;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int j = lane + 32 * u;
      if (j < N) {
        const int r = s_r[j];
        x2[u] = __ldg(t2_row + r);
        x3[u] = __ldg(t3_head + static_cast<size_t>(j) * a.P + r);
      }
    }
  }

  // scores, kGroups * kGu keys a round (B3: q_i.k_j alone, completed below)
  for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
    Chunk<T> kc[kGu][kCpl], ac[kGu][kCpl], bc[kGu][kCpl];
    load_round(a.k + head, j0, N, Dh, grp, li, kc);
    if constexpr (!kTables) {
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        if (j < N) {
          const size_t row =
              bank + static_cast<size_t>(s_r[j]) * a.bank_stride;
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C) {
              load_chunk(a.a_bank + row + c * 8, ac[uu][cc]);
              load_chunk(a.b_bank + row + c * 8, bc[uu][cc]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int j = j0 + grp + kGroups * uu;
      float s = 0.f, t4 = 0.f;
      if (j < N) {
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float q8[8], k8[8];
            unpack(qc[cc], q8);
            unpack(kc[uu][cc], k8);
            if constexpr (kTables) {
#pragma unroll
              for (int e = 0; e < 8; ++e) s += q8[e] * k8[e];
            } else {
              float a8[8], b8[8];
              unpack(ac[uu][cc], a8);
              unpack(bc[uu][cc], b8);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                s += q8[e] * k8[e] + q8[e] * b8[e] + k8[e] * a8[e];
                t4 += a8[e] * b8[e];
              }
            }
          }
        }
      }
      s = group_sum(s);
      if constexpr (!kTables) t4 = group_sum(t4);
      if (j < N && li == 0)
        e_row[j] = kTables ? s
                           : (s + round_to<T>(t4)) * a.scale + s_mask[j];
    }
  }
  __syncwarp();

  // the exact two-pass softmax over the row's N scores, lanes across keys;
  // B3 completes each score first, (q.k + T2 + T3) * scale + mask
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < kKeys; ++u) {
    const int j = lane + 32 * u;
    if (j < N) {
      if constexpr (kTables)
        e_row[j] = (e_row[j] + to_f32(x2[u]) + to_f32(x3[u])) * a.scale +
                   s_mask[j];
      m = fmaxf(m, e_row[j]);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float p = expf(e_row[j] - m);
    e_row[j] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < N; j += 32) e_row[j] = round_to<T>(e_row[j] / sum);
  __syncwarp();

  // out_i = sum_j p_ij v_j: each group its own keys, in the same rounds
  float acc[kCpl * 8];
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) acc[x] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
    Chunk<T> vc[kGu][kCpl];
    load_round(a.v + head, j0, N, Dh, grp, li, vc);
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
  for (int x = 0; x < kCpl * 8; ++x) acc[x] = groups_sum(acc[x]);
  if (grp == 0) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) store8(a.out + own + c * 8, acc + cc * 8);
    }
  }
}

// B3 and B3', each its own name in a profile
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
rel_attn_fwd_tables(const FwdArgs<T> a) {
  fwd_row<Rel::kTables, T, kCpl, kGu>(a);
}

template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
rel_attn_fwd_inline(const FwdArgs<T> a) {
  fwd_row<Rel::kBanks, T, kCpl, kGu>(a);
}

template <Rel kRel, typename T, int kCpl, int kGu>
void start(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid(a.N, (a.H + kHeads - 1) / kHeads, B);
  const int threads = 32 * (a.H < kHeads ? a.H : kHeads);
  if constexpr (kRel == Rel::kTables)
    rel_attn_fwd_tables<T, kCpl, kGu><<<grid, threads, 0, stream>>>(a);
  else
    rel_attn_fwd_inline<T, kCpl, kGu><<<grid, threads, 0, stream>>>(a);
}

#ifdef GTOS_B3_VARIANTS
constexpr int kVariants = 3;
#else
constexpr int kVariants = 0;
#endif
int g_forced_variant = -1;

// Rows up to 64 wide: B3' 2 pairs a group a round, B3 4 in bf16 and 2 in
// f32 (measured: PERF.md, Findings); GTOS_B3_VARIANTS lets B3 take 2, 4 or
// 8 in either type (chip_b6_variants.py --kernels global --variants).
template <Rel kRel, typename T>
int launch(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  if (a.Dh > 64) {
    start<kRel, T, 2, 1>(a, B, stream);
  } else if constexpr (kRel == Rel::kBanks) {
    start<kRel, T, 1, 2>(a, B, stream);
  } else {
#ifdef GTOS_B3_VARIANTS
    switch (g_forced_variant) {
      case 0: start<kRel, T, 1, 2>(a, B, stream); break;
      case 1: start<kRel, T, 1, 4>(a, B, stream); break;
      case 2: start<kRel, T, 1, 8>(a, B, stream); break;
    }
    if (g_forced_variant >= 0) return static_cast<int>(cudaGetLastError());
#endif
    start<kRel, T, 1, sizeof(T) == 2 ? 4 : 2>(a, B, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int B, int H, int N, int Dh, int P) {
  return N < 1 || N > kMaxN || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
         B < 1 || H < 1 || P < 1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Runs f(T()) for dtype 0 (float) or 1 (bfloat16).
template <typename F> int by_dtype(int dtype, F f) {
  if (dtype == 0) return f(0.f);
  if (dtype == 1) return f(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the tables or banks, and
// out). On one device: q, k, v, out [B, H, N, Dh] contiguous and 16-byte
// aligned; idx [B, N, N] int32 bank rows in [0, P); mask [B, N] bytes
// (nonzero = real node). Dh a multiple of 8, at most 128; N at most 128.
// Each returns the CUDA error code of the launch (0 = launched).

// B3: t2, t3 [B, H, N, P] contiguous (read a value at a time: any P >= 1).
extern "C" int gtos_rel_attn_fwd_tables(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* t2, const void* t3,
                                        const void* idx, const void* mask,
                                        void* out, int B, int H, int N,
                                        int Dh, int P, float scale,
                                        void* stream) {
  if (bad_sizes(B, H, N, Dh, P) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    const FwdArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(t2),
        static_cast<const T*>(t3), nullptr, nullptr,
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), P, 0, H, N, Dh, scale};
    return launch<Rel::kTables>(a, B, s);
  });
}

// Forces B3's design v in [0, kVariants) (any other v: the default);
// returns kVariants, 0 unless built with GTOS_B3_VARIANTS.
extern "C" int gtos_rel_attn_fwd_tables_variant(int v) {
  g_forced_variant = v >= 0 && v < kVariants ? v : -1;
  return kVariants;
}

// B3': a_bank, b_bank [P, H, Dh] with the last two dimensions contiguous
// and bank_stride elements between two rows (one half of a [P, 2*H*Dh]
// projection has bank_stride 2*H*Dh); both banks 16-byte aligned, and
// bank_stride a multiple of 16 bytes.
extern "C" int gtos_rel_attn_fwd_inline(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* a_bank,
                                        const void* b_bank,
                                        long long bank_stride,
                                        const void* idx, const void* mask,
                                        void* out, int B, int H, int N,
                                        int Dh, int P, float scale,
                                        void* stream) {
  const long long elt = dtype == 0 ? 4 : 2;
  if (bad_sizes(B, H, N, Dh, P) ||
      bank_stride < static_cast<long long>(H) * Dh ||
      bank_stride * elt % 16 != 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(a_bank) || !aligned16(b_bank) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    const FwdArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), nullptr, nullptr,
        static_cast<const T*>(a_bank), static_cast<const T*>(b_bank),
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), P, bank_stride, H, N, Dh, scale};
    return launch<Rel::kBanks>(a, B, s);
  });
}
