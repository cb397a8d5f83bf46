// Relation-aware graph attention over the batch-global relation bank,
// forward, for Hopper (sm_90a): two kernels.
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
// T2(i, r) = q_i.b_r + t4_r, T3(j, r) = k_j.a_r, every product summed in
// f32, where t4_r = a_r.b_r is summed in f32 and rounded to the bank type,
// as the TPU kernel folds it into a padding lane of b_bank
// (relation_attention.py:282).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): a few
// hundred MFLOP per batch against the bytes of q, k, v, out, idx, and of
// the table entries (B3) or bank rows (B3') that the pairs reference: the
// bytes bound both. What holds them above it is the latency of their
// gathers.
//
// Design. The TPU kernels stream whole [N, P] table planes (or build them
// chunk by chunk from VMEM-resident banks) because Mosaic's gather is a
// shuffle inside one vector register. A GPU thread can load any address,
// so here each pair reads only what it needs.
//   B3 (`rel_attn_fwd_tables`): a block per (graph, head, 8 query rows); k
//   (transposed, f32) and v of that (graph, head) staged in shared memory;
//   a warp per query row, lanes across keys for the scores (two table
//   entries a pair) and the softmax, across the head dimension for the
//   output.
//   B3' (`rel_attn_fwd_inline`): the skeleton of the localized B1
//   (local_relation_attention_fwd.cu) on the batch-global bank, whose
//   graph stride is 0: a block per (graph, query row i) and up to 8 heads,
//   a warp a head; the block stages row i's N bank rows and the key mask
//   once for its heads, so the heads' warps read each pair's all-heads
//   bank rows a_r, b_r (H*Dh contiguous values) together; 4 groups of 8
//   lanes a warp, a group kGu pairs a round, each lane its 16-byte chunks
//   of k_j, a_r and b_r, from which it also forms its part of t4_r; the N
//   scores of each head in shared memory for the exact two-pass softmax;
//   the probabilities, rounded to v's type, weight v_j in the same rounds
//   and the 4 groups' sums add in a fixed butterfly. The banks are strided
//   views: rows `bank_stride` elements apart (2*H*Dh for the halves of the
//   layer's [P, 2*H*Dh] projection).

#include <math.h>

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kMaxN = 128;            // node bucket limit (as the TPU kernel)
constexpr int kWarps = 8;             // B3: query rows per block
constexpr int kMaxJPL = kMaxN / 32;   // B3: keys per lane
constexpr int kMaxDPL = 4;            // B3: head dims per lane, Dh <= 128
constexpr int kHeads = 8;             // B3': head warps a block
constexpr int kGl = kPairLanes;       // B3': lanes a pair
constexpr int kGroups = 32 / kGl;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rel_attn_fwd_tables(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ t2,
                    const T* __restrict__ t3,
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
    float t1 = 0.f;
    for (int d = 0; d < Dh; ++d) t1 += qi[d] * kT[d * N + j];
    const float rel2 = to_f32(t2[(bh * N + i) * P + r]);
    const float rel3 = to_f32(t3[(bh * N + j) * P + r]);
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
    if (j < N) row[j] = round_to<T>(e[u] / s);  // attn, input type
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

template <typename T> struct InlineArgs {
  const T* q; const T* k; const T* v; const T* a_bank; const T* b_bank;
  const int32_t* idx; const uint8_t* mask; T* out;
  long long bank_stride;    // elements between two rows of the banks
  int H, N, Dh;
  float scale;
};

// Query row blockIdx.x of graph blockIdx.z, warp w the head
// blockIdx.y * 8 + w; a lane holds kCpl chunks of a row (Dh up to 64 kCpl),
// a group kGu pairs a round.
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
rel_attn_fwd_inline(const InlineArgs<T> a) {
  __shared__ int s_r[kMaxN];               // row i's bank rows
  __shared__ float s_mask[kMaxN];          // 0 or -1e9 per key
  __shared__ float s_e[kHeads][kMaxN];     // scores, then probabilities

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int i = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, C = Dh / 8;
  const int h = blockIdx.y * kHeads + warp;
  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
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
            load_chunk(a.k + krow + c * 8, kc[uu][cc]);
            load_chunk(a.a_bank + row + c * 8, ac[uu][cc]);
            load_chunk(a.b_bank + row + c * 8, bc[uu][cc]);
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
            float q8[8], k8[8], a8[8], b8[8];
            unpack(qc[cc], q8);
            unpack(kc[uu][cc], k8);
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
      s = group_sum(s);
      t4 = group_sum(t4);
      if (j < N && li == 0)
        e_row[j] = (s + round_to<T>(t4)) * a.scale + s_mask[j];
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
  for (int j = lane; j < N; j += 32) e_row[j] = round_to<T>(e_row[j] / sum);
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
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C)
            load_chunk(a.v + head + static_cast<size_t>(j) * Dh + c * 8,
                       vc[uu][cc]);
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
  for (int x = 0; x < kCpl * 8; ++x) acc[x] = groups_sum(acc[x]);
  if (grp == 0) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) store8(a.out + own + c * 8, acc + cc * 8);
    }
  }
}

template <typename T>
int launch_tables(const void* q, const void* k, const void* v, const void* t2,
                  const void* t3, const void* idx, const void* mask,
                  void* out, int B, int H, int N, int Dh, int P, float scale,
                  cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(Dh) * N + kWarps * Dh + kWarps * N + N) *
          sizeof(float) +
      static_cast<size_t>(N) * Dh * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      rel_attn_fwd_tables<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kWarps - 1) / kWarps, H, B);
  rel_attn_fwd_tables<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(t2),
      static_cast<const T*>(t3), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, N, Dh, P,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCpl, int kGu>
int launch_inline(const InlineArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid(a.N, (a.H + kHeads - 1) / kHeads, B);
  const int threads = 32 * (a.H < kHeads ? a.H : kHeads);
  rel_attn_fwd_inline<T, kCpl, kGu><<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int B, int H, int N, int Dh, int P) {
  return N < 1 || N > kMaxN || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
         B < 1 || H < 1 || P < 1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the tables or banks, and
// out). On one device: q, k, v, out [B, H, N, Dh] contiguous; idx [B, N,
// N] int32 bank rows in [0, P); mask [B, N] bytes (nonzero = real node).
// Dh a multiple of 8, at most 128; N at most 128. Each returns the CUDA
// error code of the launch (0 = launched).

// B3: t2, t3 [B, H, N, P] contiguous.
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
    return launch_tables<float>(q, k, v, t2, t3, idx, mask, out, B, H, N, Dh,
                                P, scale, s);
  if (dtype == 1)
    return launch_tables<__nv_bfloat16>(q, k, v, t2, t3, idx, mask, out, B,
                                        H, N, Dh, P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B3': a_bank, b_bank [P, H, Dh] with the last two dimensions contiguous
// and bank_stride elements between two rows (one half of a [P, 2*H*Dh]
// projection has bank_stride 2*H*Dh); both banks, q, k, v and out 16-byte
// aligned, and bank_stride a multiple of 16 bytes.
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
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const InlineArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(a_bank),
        static_cast<const T*>(b_bank), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(mask), static_cast<T*>(out),
        bank_stride, H, N, Dh, scale};
    return Dh > 64 ? launch_inline<T, 2, 1>(a, B, s)
                   : launch_inline<T, 1, 2>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}
