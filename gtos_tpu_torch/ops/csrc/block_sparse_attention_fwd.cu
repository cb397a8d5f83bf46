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
// kept pair and head about 4 Dh multiply-adds, against the bytes of q, k,
// v, out, the tile planes and the bank rows the kept pairs reference: the
// bytes bound it, most of them the bank rows (8-16k rows at c5's khop 4).
// What holds the kernel above it is the latency of its gathers: each kept
// pair reads its partner's k and v rows and its bank rows from L2, rows
// that differ from pair to pair.
//
// Design: the TPU kernel keeps both banks resident in VMEM and builds the
// relation terms of a 128x128 block from P/128 bank-chunk matmuls, because
// Mosaic's gather is a shuffle inside one vector register. A GPU thread
// can load any address, so here a pair reads only its own rows, as in
// B6d's pass (block_sparse_attention_bwd.cu), whose skeleton this is:
//   - a block per dst node and up to 8 heads, a warp a head (a second
//     block along y for H > 8); the node's tile planes are read once for
//     all heads: each warp reads one slot's tile id and plane row (8 slots
//     in one round trip) and compacts its kept pairs by ballot into a list
//     in shared memory (partner, bank row); after a barrier every head's
//     warp walks the whole list (blk::plane_round). A node with more slots
//     than warps takes them in rounds;
//   - a warp takes the list in rounds: 4 groups of 8 lanes, a group holding
//     kGu pairs and each lane reading its 16-byte chunks (32 bytes in f32)
//     of k_j, a_r, b_r and v_j at once, so a round costs one round trip;
//     the score is a 3-step shuffle sum in the group against the node's q
//     held in registers;
//   - each group keeps its own online softmax (running max and sum in f32)
//     and partial output, rescaled as its max grows; the 4 groups' (m, l,
//     out) merge in a fixed butterfly at the end. No atomics: two launches
//     give the same bits.
// kGu and the registers a thread may hold trade the round trips in flight
// per warp against the warps per SM. Nodes past N (the padding of the last
// tile) are never read or written.

#include <math.h>

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kWarps = 8;             // heads per block
constexpr int kThreads = kWarps * 32;

template <typename T> struct FwdArgs {
  const T* q; const T* k; const T* v; const T* a_bank; const T* b_bank;
  const float* t4; const int32_t* tile_src; const int32_t* tile_rel;
  T* out; float* m_out; float* l_out;
  int H, N, Dh, P, Td, Smax;
  float scale;
};

// The block of dst node blockIdx.x of graph blockIdx.z, warp w the head
// blockIdx.y * 8 + w (warps past H only help read the planes); a lane holds
// kCpl chunks of a row (Dh up to 64 kCpl).
template <typename T, int kCpl, int kGu, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blk_attn_fwd_kernel(const FwdArgs<T> a) {
  constexpr int kGl = 8;                       // lanes per pair
  constexpr int kGroups = 32 / kGl;
  constexpr int kRound = kGroups * kGu;        // pairs a warp holds
  constexpr int kList = kWarps * kTile;        // pairs of 8 plane rows
  __shared__ int list_o[kList];    // src node j
  __shared__ int list_r[kList];    // bank row r
  __shared__ int counts[kWarps];

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh;
  const int h = blockIdx.y * kWarps + warp;
  const bool active = h < H;
  const int grp = lane / kGl, li = lane % kGl;
  const int C = Dh / 8;
  const size_t bh = static_cast<size_t>(b) * H + (active ? h : 0);
  const size_t head = bh * N * Dh;
  const size_t own_row = head + static_cast<size_t>(n) * Dh;

  float qf[kCpl * 8], acc[kCpl * 8];
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    Chunk<T> c;
    if (active && li + kGl * cc < C) {
      load_chunk(a.q + own_row + (li + kGl * cc) * 8, c);
      unpack(c, qf + cc * 8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[cc * 8 + e] = 0.f;
    }
  }
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) acc[x] = 0.f;
  float m = -INFINITY, l = 0.f;   // this group's running max and sum

  // pairs [x0, x0 + cnt) of the list, kGu a group
  auto take = [&](int x0, int cnt) {
    Chunk<T> kc[kGu][kCpl], ac[kGu][kCpl], bc[kGu][kCpl], vc[kGu][kCpl];
    float t4v[kGu];
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int x = grp + kGroups * uu;
      t4v[uu] = 0.f;
      if (x < cnt) {
        const int j = list_o[x0 + x], r = list_r[x0 + x];
        const size_t jrow = head + static_cast<size_t>(j) * Dh;
        const size_t row = (static_cast<size_t>(r) * H + h) * Dh;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C) {
            load_chunk(a.k + jrow + c * 8, kc[uu][cc]);
            load_chunk(a.a_bank + row + c * 8, ac[uu][cc]);
            load_chunk(a.b_bank + row + c * 8, bc[uu][cc]);
            load_chunk(a.v + jrow + c * 8, vc[uu][cc]);
          }
        }
        t4v[uu] = __ldg(a.t4 + static_cast<size_t>(r) * H + h);
      }
    }
    float e[kGu];
    float mx = m;
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const bool ok = grp + kGroups * uu < cnt;
      float s = 0.f;
      if (ok) {
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float k8[8], a8[8], b8[8];
            unpack(kc[uu][cc], k8);
            unpack(ac[uu][cc], a8);
            unpack(bc[uu][cc], b8);
#pragma unroll
            for (int d = 0; d < 8; ++d)
              s += qf[cc * 8 + d] * (k8[d] + b8[d]) + k8[d] * a8[d];
          }
        }
      }
#pragma unroll
      for (int off = 1; off < kGl; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      e[uu] = ok ? (s + t4v[uu]) * a.scale : -INFINITY;
      mx = fmaxf(mx, e[uu]);
    }
    if (mx == -INFINITY) return;   // the group holds no pair this round
    const float alpha = expf(m - mx);   // 0 on the group's first pair
    l *= alpha;
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) acc[x] *= alpha;
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      if (grp + kGroups * uu < cnt) {
        const float p = expf(e[uu] - mx);
        l += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float v8[8];
            unpack(vc[uu][cc], v8);
#pragma unroll
            for (int d = 0; d < 8; ++d) acc[cc * 8 + d] += pr * v8[d];
          }
        }
      }
    }
    m = mx;
  };

  const int t = n / kTile, nl = n - t * kTile;
  const size_t tile_row = static_cast<size_t>(b) * a.Td + t;
  for (int s0 = 0; s0 < a.Smax; s0 += warps) {
    const int all = plane_round(a.tile_src, a.tile_rel, nullptr, tile_row,
                                nl, s0, a.Smax, a.P, N, counts, list_o,
                                list_r, nullptr);
    if (active)
      for (int x0 = 0; x0 < all; x0 += kRound) take(x0, min(kRound, all - x0));
    __syncthreads();  // the lists are rewritten for the next slots
  }
  if (!active) return;

  // the 4 groups' (m, l, out), in a fixed butterfly; group 0 writes
#pragma unroll
  for (int off = kGl; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m_o);
    const float s_own = mx == -INFINITY ? 0.f : expf(m - mx);
    const float s_oth = mx == -INFINITY ? 0.f : expf(m_o - mx);
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[x], off);
      acc[x] = acc[x] * s_own + acc_o * s_oth;
    }
    l = l * s_own + l_o * s_oth;
    m = mx;
  }
  if (grp != 0) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    const int c = li + kGl * cc;
    if (c < C) {
      float o8[8];
#pragma unroll
      for (int d = 0; d < 8; ++d) o8[d] = l > 0.f ? acc[cc * 8 + d] * inv : 0.f;
      store8(a.out + own_row + c * 8, o8);
    }
  }
  if (a.m_out != nullptr && li == 0) {
    a.m_out[bh * N + n] = l > 0.f ? m : -1e9f;
    a.l_out[bh * N + n] = l;
  }
}

#ifdef GTOS_B5_VARIANTS
constexpr int kVariants = 4;
#else
constexpr int kVariants = 0;
#endif
int g_forced_variant = -1;

template <typename T, int kCpl, int kGu, int kMinBlocks>
int launch_one(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid(a.N, (a.H + kWarps - 1) / kWarps, B);
  const int threads = 32 * (a.H < kWarps ? a.H : kWarps);
  blk_attn_fwd_kernel<T, kCpl, kGu, kMinBlocks>
      <<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel for rows up to 64 wide: 2 pairs a group at 3 blocks an
// SM. Built with GTOS_B5_VARIANTS, the source also holds four (kGu,
// kMinBlocks) variants, and gtos_blk_attn_fwd_variant forces one
// (chip_b6_variants.py --variants).
template <typename T>
int launch(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  if (a.Dh > 64) return launch_one<T, 2, 1, 1>(a, B, stream);
  if constexpr (sizeof(T) != 2) {
    return launch_one<T, 1, 2, 1>(a, B, stream);
  } else {
#ifdef GTOS_B5_VARIANTS
    switch (g_forced_variant) {
      case 0: return launch_one<T, 1, 1, 4>(a, B, stream);
      case 1: return launch_one<T, 1, 2, 3>(a, B, stream);
      case 2: return launch_one<T, 1, 2, 4>(a, B, stream);
      case 3: return launch_one<T, 1, 4, 2>(a, B, stream);
    }
#endif
    return launch_one<T, 1, 2, 3>(a, B, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the banks and out). All
// tensors contiguous on one device: q, k, v, out [B, H, N, Dh] (16-byte
// aligned); a_bank, b_bank [P, H, Dh] (16-byte aligned); t4 [P, H]
// float32; tile_src [B, Td, Smax] int32 (-1 = empty slot); tile_rel
// [B, Td, Smax, 128, 128] int32 (-1 = dropped pair), N <= Td * 128; m_out,
// l_out [B, H, N] float32, or both null for B5. Dh a multiple of 8, at most
// 128. Returns the CUDA error code of the launch (0 = launched).
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
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const FwdArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(a_bank),
        static_cast<const T*>(b_bank), static_cast<const float*>(t4),
        static_cast<const int32_t*>(tile_src),
        static_cast<const int32_t*>(tile_rel), static_cast<T*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out),
        H, N, Dh, P, Td, Smax, scale};
    return launch<T>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

// Forces the bf16 variant v in [0, kVariants) for rows up to 64 wide (any
// other v: the kernel's own); returns kVariants (0 unless built with
// GTOS_B5_VARIANTS).
extern "C" int gtos_blk_attn_fwd_variant(int v) {
  g_forced_variant = v >= 0 && v < kVariants ? v : -1;
  return kVariants;
}
