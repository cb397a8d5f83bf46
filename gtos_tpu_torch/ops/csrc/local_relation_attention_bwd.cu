// Localized relation-aware graph attention, backward, for Hopper (sm_90a):
// three launches, counted as one call.
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
// and the dense g_a/g_b outputs: the bytes bound it. What holds the kernel
// above it is the latency of its gathers (each pair's bank rows, rows of
// other nodes), so the design keeps many in flight and reads each row once
// for all heads, on the skeleton of the block-sparse B5/B6
// (csrc/block_sparse_common.cuh): a block takes up to 8 heads, a warp a
// head, 4 groups of 8 lanes a warp, a group a pair (or, in the bank pass,
// a short run), each lane 16 bytes of a row at a time.
//
// The TPU kernel turns the two scatter-adds (pairs -> slots) into a sort, a
// triangular-matmul prefix sum and boundary gathers. Here:
//   1. the row pass (`local_bwd_rows`), a block per (graph, query row i):
//      the heads share row i's slots; each warp scores g_i.v_j for its
//      head, takes the row sum, writes ge_ij and sums gq_i = sum_j ge_ij
//      (k_j + b_r). It writes each pair's (ge, p) for the block's heads in
//      key-major order, gep [B, N(j), N(i), H] float2, so that a key's
//      column and a pair's heads are contiguous for the next passes. More
//      blocks of the same launch write the rows of the empty slots as 0
//      (most of a batch's slots: its graphs' banks are padded to the
//      batch's P_loc), which needs nothing the row pass computes;
//   2. `local_bwd_mid`, of two kinds of block:
//      - a column block per (graph, key j): gk_j = sum_i ge_ij (q_i + a_r)
//        and gv_j = sum_i p_ij g_i from gep's column j;
//      - the bank gradients of the long runs: over `pair_order` (each
//        graph's pairs sorted by slot), the runs of more than kShortRun
//        pairs (the pad slot 0 of a graph much smaller than its node
//        bucket holds most of a batch's pairs) are cut into kChunk-pair
//        chunks, listed per graph by `bank_runs` on the card without a
//        host sync; a chunk block's head warps share one staging of the
//        chunk's pairs and their ge, its 4 groups each sum a quarter and
//        add their sums in a fixed butterfly; a run of one chunk is
//        written there, the chunks of a longer run to a workspace;
//   3. `local_bwd_finish`: blocks that add a long run's chunks in chunk
//      order and write its rows, and slot blocks in which a lane group
//      takes kSpg of the other non-empty runs, each whole (most hold one
//      pair), from `bank_runs`' list of them, longest first; it reads a
//      run's pairs at once, a lane each, with no staging and no barrier.
// g_a[r] is summed as sum ge_ij k_j + b_r sum ge_ij (and g_b[r] the same
// way), so a pair costs no add of its bank row; summing ge_ij (k_j + b_r)
// per pair was measured no faster on the H100, and neither were more
// pairs a group a round, a slot block's pairs staged in shared memory, or
// a row pass that stages k and v (PERF.md, Findings). No atomics
// anywhere, so the result is the same bit for bit on every run. The banks
// are read, and their gradients written, as strided views (row strides
// `bank_stride` and `out_stride` elements): the wrapper hands the halves
// of the layer's [B, P_loc, 2*H*Dh] projection and of one [B, P_loc,
// 2*H*Dh] gradient.

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kMaxN = 128;       // node bucket limit (as the TPU kernel)
constexpr int kHeads = 8;        // head warps a block
constexpr int kGl = kPairLanes;  // lanes a pair
constexpr int kGroups = 32 / kGl;
constexpr int kShortRun = 8;     // runs a lane group takes whole, a lane a pair
constexpr int kChunk = 32;       // a longer run's pairs a chunk block
constexpr int kZeroRows = 32;    // empty slots' rows a block writes
static_assert(kShortRun <= kGl, "a short run's pairs are a lane each");

template <typename T> struct BwdArgs {
  const T* q; const T* k; const T* v; const float* g; const float* probs;
  const T* a_loc; const T* b_loc;
  const int32_t* idx; const int32_t* pair_order; const int32_t* slot_start;
  // `bank_runs` [B, 1 + cmax + P]: entry 0 (chunks, short runs, 0, 0);
  // from 1 the chunks (first place in pair_order, pairs, slot, chunk of its
  // run) of the runs of more than kShortRun pairs; from 1 + cmax the other
  // non-empty runs (first place, pairs, slot, 0), longest first
  const int4* runs;
  float2* gep;     // [B, N(j), N(i), H] (ge, p)
  float* part;     // [B, cmax, H, 2 Dh + 4] a chunk's sums for g_b, g_a, ge
  T* gq; T* gk; T* gv; T* ga; T* gb;
  long long bank_stride, out_stride;   // elements between two bank rows
  int H, N, Dh, P, cmax, n_chunk_blocks, n_zero_blocks;
  float scale;
  bool vec;        // Dh % 8 == 0 and every row 16-byte aligned
};

// the rows of empty slots [r0, r0 + kZeroRows) of graph b written as 0,
// all heads, 16 bytes a thread where rows allow
template <typename T>
__device__ __forceinline__ void zero_empty_rows(const BwdArgs<T>& a, int b,
                                                int r0, int* s_len) {
  const int32_t* st = a.slot_start + static_cast<size_t>(b) * (a.P + 1);
  for (int r = threadIdx.x; r < kZeroRows; r += blockDim.x)
    s_len[r] = r0 + r < a.P ? __ldg(st + r0 + r + 1) - __ldg(st + r0 + r) : 1;
  __syncthreads();
  const int width = a.H * a.Dh;                     // values a row
  const int per = a.vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int units = width / per;
  for (int e = threadIdx.x; e < kZeroRows * units; e += blockDim.x) {
    const int r = e / units;
    if (s_len[r] != 0) continue;
    const size_t at = (static_cast<size_t>(b) * a.P + r0 + r) * a.out_stride +
                      static_cast<size_t>(e - r * units) * per;
    if (a.vec) {
      *reinterpret_cast<uint4*>(a.ga + at) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(a.gb + at) = make_uint4(0, 0, 0, 0);
    } else {
      a.ga[at] = from_f32<T>(0.f);
      a.gb[at] = from_f32<T>(0.f);
    }
  }
}

// 1. Query row blockIdx.x of graph blockIdx.z; warp w the head
// blockIdx.y * 8 + w. A lane holds kCpl chunks of a row (Dh up to 64 kCpl),
// a group kGu pairs a round. Blocks N.. of head block 0 write the empty
// slots' rows, kZeroRows slots a block.
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
local_bwd_rows(const BwdArgs<T> a) {
  __shared__ int s_r[kMaxN];               // row i's slots
  __shared__ float s_p[kHeads][kMaxN];     // p_ij
  __shared__ float s_ge[kHeads][kMaxN];    // g_i.v_j, then ge_ij

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int i = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, C = (Dh + 7) / 8;
  if (i >= N) {
    if (blockIdx.y == 0) zero_empty_rows(a, b, (i - N) * kZeroRows, s_r);
    return;
  }
  const int h0 = blockIdx.y * kHeads, h = h0 + warp;
  const int nh = min(kHeads, H - h0);
  const bool active = warp < nh;
  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
  const size_t own = head + static_cast<size_t>(i) * Dh;

  Chunk<float> gc[kCpl];   // g_i, read with the row's slots and probs
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    s_r[j] = __ldg(a.idx + (static_cast<size_t>(b) * N + i) * N + j);
  if (active) {
    for (int j = lane; j < N; j += 32)
      s_p[warp][j] = __ldg(a.probs + ((static_cast<size_t>(b) * H + h) * N +
                                      i) * N + j);
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) load_chunk_n(a.g + own + c * 8, Dh - c * 8, a.vec, gc[cc]);
    }
  }
  __syncthreads();

  if (active) {
    float* ge = s_ge[warp];
    const float* p = s_p[warp];
    // g_i . v_j, kGroups * kGu keys a round
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
              load_chunk_n(a.v + head + static_cast<size_t>(j) * Dh + c * 8,
                           Dh - c * 8, a.vec, vc[uu][cc]);
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        float dot = 0.f;
        if (j < N) {
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float g8[8], v8[8];
              unpack(gc[cc], g8);
              unpack(vc[uu][cc], v8);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot += g8[e] * v8[e];
            }
          }
        }
        dot = group_sum(dot);
        if (j < N && li == 0) ge[j] = dot;
      }
    }
    __syncwarp();
    float row = 0.f;
    for (int j = lane; j < N; j += 32) row += p[j] * ge[j];
    row = warp_sum(row);
    for (int j = lane; j < N; j += 32) ge[j] = a.scale * p[j] * (ge[j] - row);
    __syncwarp();

    // gq_i = sum_j ge_ij (k_j + b_r)
    const size_t bank = static_cast<size_t>(b) * a.P * a.bank_stride +
                        static_cast<size_t>(h) * Dh;
    float acc[kCpl * 8];
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) acc[x] = 0.f;
    for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
      Chunk<T> kc[kGu][kCpl], bc[kGu][kCpl];
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        if (j < N) {
          const size_t krow = head + static_cast<size_t>(j) * Dh;
          const size_t brow =
              bank + static_cast<size_t>(s_r[j]) * a.bank_stride;
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C) {
              load_chunk_n(a.k + krow + c * 8, Dh - c * 8, a.vec, kc[uu][cc]);
              load_chunk_n(a.b_loc + brow + c * 8, Dh - c * 8, a.vec,
                           bc[uu][cc]);
            }
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        if (j < N) {
          const float w = ge[j];
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float k8[8], b8[8];
              unpack(kc[uu][cc], k8);
              unpack(bc[uu][cc], b8);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[cc * 8 + e] += w * (k8[e] + b8[e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) acc[x] = groups_sum(acc[x]);
    if (grp == 0) {
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = li + kGl * cc;
        if (c < C) store_n(a.gq + own + c * 8, acc + cc * 8, Dh - c * 8, a.vec);
      }
    }
  }
  __syncthreads();
  // (ge, p) of the block's heads at [b, j, i, h], a pair's heads contiguous
  for (int t = threadIdx.x; t < N * nh; t += blockDim.x) {
    const int j = t / nh, hh = t - j * nh;
    a.gep[((static_cast<size_t>(b) * N + j) * N + i) * H + h0 + hh] =
        make_float2(s_ge[hh][j], s_p[hh][j]);
  }
}

// head h's chunks of bank row r of graph b (lane li of a group), loaded
// before the row's sums so that their round trip overlaps the sums'
template <typename T, int kCpl>
__device__ __forceinline__ void load_bank_row(const BwdArgs<T>& a, int b,
                                              int r, int h, int li,
                                              Chunk<T>* ac, Chunk<T>* bc) {
  const int Dh = a.Dh, C = (Dh + 7) / 8;
  const size_t in = (static_cast<size_t>(b) * a.P + r) * a.bank_stride +
                    static_cast<size_t>(h) * Dh;
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    const int c = li + kGl * cc;
    if (c < C) {
      load_chunk_n(a.a_loc + in + c * 8, Dh - c * 8, a.vec, ac[cc]);
      load_chunk_n(a.b_loc + in + c * 8, Dh - c * 8, a.vec, bc[cc]);
    }
  }
}

// a bank row's gradient from its sums: g_b[r] = sq + dt a_r and g_a[r] =
// sk + dt b_r (a_r, b_r: load_bank_row's chunks); lane li of a group writes
// its chunks of head h
template <typename T, int kCpl>
__device__ __forceinline__ void write_bank_row(const BwdArgs<T>& a, int b,
                                               int r, int h, int li,
                                               const float* sq,
                                               const float* sk, float dt,
                                               const Chunk<T>* ac,
                                               const Chunk<T>* bc) {
  const int Dh = a.Dh, C = (Dh + 7) / 8;
  const size_t out = (static_cast<size_t>(b) * a.P + r) * a.out_stride +
                     static_cast<size_t>(h) * Dh;
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    const int c = li + kGl * cc;
    if (c < C) {
      float a8[8], b8[8], ob[8], oa[8];
      unpack(ac[cc], a8);
      unpack(bc[cc], b8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ob[e] = sq[cc * 8 + e] + dt * a8[e];
        oa[e] = sk[cc * 8 + e] + dt * b8[e];
      }
      store_n(a.gb + out + c * 8, ob, Dh - c * 8, a.vec);
      store_n(a.ga + out + c * 8, oa, Dh - c * 8, a.vec);
    }
  }
}

// A group's sums over a chunk's staged pairs grp, grp + 4, ... below `end`,
// kGu a round trip: sq += w q_i, sk += w k_j, dt += w. s_pair holds the
// pairs (i * N + j), w the head's ge.
template <typename T, int kCpl, int kGu>
__device__ __forceinline__ void run_sums(const BwdArgs<T>& a, size_t head,
                                         const int* s_pair, const float* w,
                                         int grp, int end, int li, float* sq,
                                         float* sk, float& dt) {
  const int N = a.N, Dh = a.Dh, C = (Dh + 7) / 8;
  for (int x = grp; x < end; x += kGroups * kGu) {
    Chunk<T> qc[kGu][kCpl], kc[kGu][kCpl];
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int s = x + kGroups * uu;
      if (s < end) {
        const int pair = s_pair[s];
        const int i = pair / N, j = pair - i * N;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C) {
            load_chunk_n(a.q + head + static_cast<size_t>(i) * Dh + c * 8,
                         Dh - c * 8, a.vec, qc[uu][cc]);
            load_chunk_n(a.k + head + static_cast<size_t>(j) * Dh + c * 8,
                         Dh - c * 8, a.vec, kc[uu][cc]);
          }
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int s = x + kGroups * uu;
      if (s < end) {
        const float ws = w[s];
        dt += ws;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float q8[8], k8[8];
            unpack(qc[uu][cc], q8);
            unpack(kc[uu][cc], k8);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sq[cc * 8 + e] += ws * q8[e];
              sk[cc * 8 + e] += ws * k8[e];
            }
          }
        }
      }
    }
  }
}

// 2. Blocks [0, n_chunk_blocks) of graph blockIdx.z: long-run chunks
// blockIdx.x, + n_chunk_blocks, ...; then N column blocks. Warp w is head
// blockIdx.y * 8 + w.
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
local_bwd_mid(const BwdArgs<T> a) {
  __shared__ union {
    struct { int r[kMaxN]; float ge[kHeads][kMaxN]; float p[kHeads][kMaxN]; }
        col;
    struct { int pair[kChunk]; float w[kHeads][kChunk]; } run;
  } sm;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, P = a.P, C = (Dh + 7) / 8;
  const int h0 = blockIdx.y * kHeads, h = h0 + warp;
  const int nh = min(kHeads, H - h0);
  const bool active = warp < nh;
  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
  const size_t pairs0 = static_cast<size_t>(b) * N * N;
  const int32_t* st = a.slot_start + static_cast<size_t>(b) * (P + 1);
  // ge of staged pair s for the block's heads: a pair's heads in one read
  auto stage = [&](int s, int pair) {
    const int i = pair / N, j = pair - i * N;
    sm.run.pair[s] = pair;
    const float2* e = a.gep + ((pairs0 + static_cast<size_t>(j) * N + i) * H +
                               h0);
    for (int hh = 0; hh < nh; ++hh) sm.run.w[hh][s] = e[hh].x;
  };
  int x = blockIdx.x;
  if (x < a.n_chunk_blocks) {
    // long-run chunks: the 4 groups share a chunk's pairs
    const int4* list =
        a.runs + static_cast<size_t>(b) * (1 + a.cmax + a.P);
    const int n = __ldg(&list[0].x);
    for (int c = x; c < n; c += a.n_chunk_blocks) {
      const int4 it = __ldg(list + 1 + c);
      for (int s = threadIdx.x; s < it.y; s += blockDim.x)
        stage(s, __ldg(a.pair_order + pairs0 + it.x + s));
      __syncthreads();
      if (active) {
        Chunk<T> ac[kCpl], bc[kCpl];
        float sq[kCpl * 8] = {}, sk[kCpl * 8] = {}, dt = 0.f;
        load_bank_row<T, kCpl>(a, b, it.z, h, li, ac, bc);
        run_sums<T, kCpl, kGu>(a, head, sm.run.pair, sm.run.w[warp], grp,
                               it.y, li, sq, sk, dt);
        dt = groups_sum(dt);
#pragma unroll
        for (int v = 0; v < kCpl * 8; ++v) {
          sq[v] = groups_sum(sq[v]);
          sk[v] = groups_sum(sk[v]);
        }
        const int len = __ldg(st + it.z + 1) - __ldg(st + it.z);
        if (grp == 0) {
          if (len <= kChunk) {   // the run's only chunk
            write_bank_row<T, kCpl>(a, b, it.z, h, li, sq, sk, dt, ac, bc);
          } else {
            float* part = a.part + ((static_cast<size_t>(b) * a.cmax + c) * H +
                                    h) * (2 * Dh + 4);
#pragma unroll
            for (int cc = 0; cc < kCpl; ++cc) {
              const int ch = li + kGl * cc;
              if (ch < C) {
                store_n(part + ch * 8, sq + cc * 8, Dh - ch * 8, a.vec);
                store_n(part + Dh + ch * 8, sk + cc * 8, Dh - ch * 8, a.vec);
              }
            }
            if (li == 0) part[2 * Dh] = dt;
          }
        }
      }
      __syncthreads();   // the staged pairs are rewritten for the next chunk
    }
    return;
  }
  {
    // column j: gk_j = sum_i ge_ij (q_i + a_r), gv_j = sum_i p_ij g_i
    const int j = x - a.n_chunk_blocks;
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      sm.col.r[i] = __ldg(a.idx + (pairs0 + static_cast<size_t>(i) * N + j));
    for (int t = threadIdx.x; t < N * nh; t += blockDim.x) {
      const int i = t / nh, hh = t - i * nh;
      const float2 e =
          a.gep[(pairs0 + static_cast<size_t>(j) * N + i) * H + h0 + hh];
      sm.col.ge[hh][i] = e.x;
      sm.col.p[hh][i] = e.y;
    }
    __syncthreads();
    if (!active) return;
    const size_t bank = static_cast<size_t>(b) * P * a.bank_stride +
                        static_cast<size_t>(h) * Dh;
    float ak[kCpl * 8], av[kCpl * 8];
#pragma unroll
    for (int v = 0; v < kCpl * 8; ++v) ak[v] = av[v] = 0.f;
    for (int i0 = 0; i0 < N; i0 += kGroups * kGu) {
      Chunk<T> qc[kGu][kCpl], ac[kGu][kCpl];
      Chunk<float> gc[kGu][kCpl];
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int i = i0 + grp + kGroups * uu;
        if (i < N) {
          const size_t row = head + static_cast<size_t>(i) * Dh;
          const size_t arow =
              bank + static_cast<size_t>(sm.col.r[i]) * a.bank_stride;
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C) {
              load_chunk_n(a.q + row + c * 8, Dh - c * 8, a.vec, qc[uu][cc]);
              load_chunk_n(a.a_loc + arow + c * 8, Dh - c * 8, a.vec,
                           ac[uu][cc]);
              load_chunk_n(a.g + row + c * 8, Dh - c * 8, a.vec, gc[uu][cc]);
            }
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int i = i0 + grp + kGroups * uu;
        if (i < N) {
          const float e = sm.col.ge[warp][i], p = sm.col.p[warp][i];
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float q8[8], a8[8], g8[8];
              unpack(qc[uu][cc], q8);
              unpack(ac[uu][cc], a8);
              unpack(gc[uu][cc], g8);
#pragma unroll
              for (int d = 0; d < 8; ++d) {
                ak[cc * 8 + d] += e * (q8[d] + a8[d]);
                av[cc * 8 + d] += p * g8[d];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kCpl * 8; ++v) {
      ak[v] = groups_sum(ak[v]);
      av[v] = groups_sum(av[v]);
    }
    if (grp == 0) {
      const size_t own = head + static_cast<size_t>(j) * Dh;
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = li + kGl * cc;
        if (c < C) {
          store_n(a.gk + own + c * 8, ak + cc * 8, Dh - c * 8, a.vec);
          store_n(a.gv + own + c * 8, av + cc * 8, Dh - c * 8, a.vec);
        }
      }
    }
  }
}

// 3. Blocks [0, n_chunk_blocks) of graph blockIdx.z: list entries
// blockIdx.x, + n_chunk_blocks, ...; for each that is the first chunk of a
// run of several, the run's chunk sums added in chunk order (warp w: head
// blockIdx.y * 8 + w, lanes across the 2 Dh sums) and its row written.
// Then slot blocks: lane group g of warp w takes the short runs kSlots x +
// t kGroups + g, t < kSpg, of the list, each whole, reading its pairs at
// once, a lane each, and their rows kGu at a time. No barrier: each group
// goes at its own pace. Four blocks an SM where a row is at most 64 wide
// (kCpl 1): the lane groups' round trips, not their registers, set the
// time. Two for wider rows, whose twice as many sums would spill at four.
template <typename T, int kCpl, int kGu, int kSpg>
__global__ void __launch_bounds__(kHeads * 32, kCpl == 1 ? 4 : 2)
local_bwd_finish(const BwdArgs<T> a) {
  constexpr int kVals = 4 * kCpl;       // sums a lane adds: 2 Dh <= 128 kCpl
  constexpr int kInFlight = 8;          // chunks read at once
  constexpr int kSlots = kGroups * kSpg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int h = blockIdx.y * kHeads + warp;
  if (h >= a.H) return;
  const int b = blockIdx.z, H = a.H, N = a.N, Dh = a.Dh, P = a.P;
  const int4* list = a.runs + static_cast<size_t>(b) * (1 + a.cmax + P);
  int x = blockIdx.x;
  if (x < a.n_chunk_blocks) {
    const int32_t* st = a.slot_start + static_cast<size_t>(b) * (P + 1);
    const int width = 2 * Dh + 4;
    const int n = __ldg(&list[0].x);
    for (int c = x; c < n; c += a.n_chunk_blocks) {
      const int4 it = __ldg(list + 1 + c);
      const int len = __ldg(st + it.z + 1) - __ldg(st + it.z);
      if (it.w != 0 || len <= kChunk) continue;
      const int chunks = (len + kChunk - 1) / kChunk;
      float s[kVals], dt = 0.f;
#pragma unroll
      for (int t = 0; t < kVals; ++t) s[t] = 0.f;
      for (int c0 = 0; c0 < chunks; c0 += kInFlight) {
        float v[kInFlight][kVals], d[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const bool ok = c0 + u < chunks;
          const float* part =
              a.part + ((static_cast<size_t>(b) * a.cmax + c + c0 + u) * H +
                        h) * width;
#pragma unroll
          for (int t = 0; t < kVals; ++t)
            v[u][t] = ok && lane + 32 * t < 2 * Dh
                          ? __ldg(part + lane + 32 * t) : 0.f;
          d[u] = ok ? __ldg(part + 2 * Dh) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
          for (int t = 0; t < kVals; ++t) s[t] += v[u][t];
          dt += d[u];
        }
      }
      const size_t in = (static_cast<size_t>(b) * P + it.z) * a.bank_stride +
                        static_cast<size_t>(h) * Dh;
      const size_t out = (static_cast<size_t>(b) * P + it.z) * a.out_stride +
                         static_cast<size_t>(h) * Dh;
#pragma unroll
      for (int t = 0; t < kVals; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh)
          a.gb[out + d] = from_f32<T>(s[t] + dt * to_f32(a.a_loc[in + d]));
        else if (d < 2 * Dh)
          a.ga[out + d - Dh] =
              from_f32<T>(s[t] + dt * to_f32(a.b_loc[in + d - Dh]));
      }
    }
    return;
  }
  x -= a.n_chunk_blocks;

  const int C = (Dh + 7) / 8;
  const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
  const size_t pairs0 = static_cast<size_t>(b) * N * N;
  const unsigned gmask = 0xffu << (grp * kGl);
#pragma unroll 1
  for (int t = 0; t < kSpg; ++t) {
    const int at = kSlots * x + t * kGroups + grp;
    if (at >= P) break;
    const int4 it = __ldg(list + 1 + a.cmax + at);
    const int s0 = it.x, len = it.y, r = it.z;
    if (len == 0) break;     // past the list's runs: zeros
    Chunk<T> ac[kCpl], bc[kCpl];
    float sq[kCpl * 8] = {}, sk[kCpl * 8] = {}, dt = 0.f;
    load_bank_row<T, kCpl>(a, b, r, h, li, ac, bc);
    // the run's pairs, a lane each, handed round the group kGu at a time
    const int mine = li < len ? __ldg(a.pair_order + pairs0 + s0 + li) : 0;
#pragma unroll 1
    for (int u0 = 0; u0 < len; u0 += kGu) {
      Chunk<T> qc[kGu][kCpl], kc[kGu][kCpl];
      float w[kGu];
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int pair = __shfl_sync(gmask, mine, u0 + uu, kGl);
        w[uu] = 0.f;
        if (u0 + uu < len) {
          const int i = pair / N, j = pair - i * N;
          w[uu] = a.gep[(pairs0 + static_cast<size_t>(j) * N + i) * H + h].x;
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C) {
              load_chunk_n(a.q + head + static_cast<size_t>(i) * Dh + c * 8,
                           Dh - c * 8, a.vec, qc[uu][cc]);
              load_chunk_n(a.k + head + static_cast<size_t>(j) * Dh + c * 8,
                           Dh - c * 8, a.vec, kc[uu][cc]);
            }
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        if (u0 + uu < len) {
          dt += w[uu];
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float q8[8], k8[8];
              unpack(qc[uu][cc], q8);
              unpack(kc[uu][cc], k8);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                sq[cc * 8 + e] += w[uu] * q8[e];
                sk[cc * 8 + e] += w[uu] * k8[e];
              }
            }
          }
        }
      }
    }
    write_bank_row<T, kCpl>(a, b, r, h, li, sq, sk, dt, ac, bc);
  }
}

// pairs a lane group takes a round trip: kGuR in the row pass, kGuM in the
// column and chunk blocks, kGuS in the slot blocks, whose lane groups take
// kSpg runs each
template <typename T, int kCpl, int kGuR, int kGuM, int kGuS, int kSpg>
int launch_one(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  const int hg = (a.H + kHeads - 1) / kHeads;
  const int threads = 32 * (a.H < kHeads ? a.H : kHeads);
  local_bwd_rows<T, kCpl, kGuR>
      <<<dim3(a.N + a.n_zero_blocks, hg, B), threads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  local_bwd_mid<T, kCpl, kGuM>
      <<<dim3(a.n_chunk_blocks + a.N, hg, B), threads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = kGroups * kSpg;
  local_bwd_finish<T, kCpl, kGuS, kSpg>
      <<<dim3(a.n_chunk_blocks + (a.P + per - 1) / per, hg, B), threads, 0,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the banks and every
// gradient). On one device: q, k, v and the outputs gq, gk, gv [B, H, N,
// Dh] contiguous; g [B, H, N, Dh] f32 and probs [B, H, N, N] f32,
// contiguous; a_loc, b_loc [B, P_loc, H, Dh] with the last two dimensions
// contiguous and bank_stride elements between two rows (P_loc * bank_stride
// between two graphs), the outputs ga, gb the same with out_stride; idx [B,
// N, N] int32 slots in [0, P_loc); pair_order [B, N*N] int32 (each graph's
// i*N+j sorted by slot, stable); slot_start [B, P_loc + 1] int32 (run
// bounds, last = N*N); runs [B, 1 + cmax + P_loc] int32x4, `bank_runs`'
// list (cmax = ceil(N*N / 9)); workspaces gep [B, N, N, H] float32x2 and
// part [B, cmax, H, 2 Dh + 4] float32. Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int gtos_local_rel_attn_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    const void* probs, const void* a_loc, const void* b_loc,
    long long bank_stride, const void* idx, const void* pair_order,
    const void* slot_start, const void* runs, void* gep, void* part,
    void* gq, void* gk, void* gv, void* ga, void* gb, long long out_stride,
    int B, int H, int N, int Dh, int P_loc, float scale, void* stream) {
  // a run of L > kShortRun pairs has ceil(L / kChunk) <= L / (kShortRun +
  // 1) chunks
  const int cmax = (N * N + kShortRun) / (kShortRun + 1);
  if (N < 1 || N > kMaxN || Dh < 1 || Dh > kMaxDh || B < 1 || H < 1 ||
      P_loc < 1 || bank_stride < static_cast<long long>(H) * Dh ||
      out_stride < static_cast<long long>(H) * Dh || !aligned16(runs))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Dh % 8 == 0 && bank_stride % 8 == 0 &&
                   out_stride % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(g) && aligned16(a_loc) &&
                   aligned16(b_loc) && aligned16(gq) && aligned16(gk) &&
                   aligned16(gv) && aligned16(ga) && aligned16(gb) &&
                   aligned16(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const BwdArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(g),
        static_cast<const float*>(probs), static_cast<const T*>(a_loc),
        static_cast<const T*>(b_loc), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(pair_order),
        static_cast<const int32_t*>(slot_start),
        static_cast<const int4*>(runs), static_cast<float2*>(gep),
        static_cast<float*>(part), static_cast<T*>(gq), static_cast<T*>(gk),
        static_cast<T*>(gv), static_cast<T*>(ga), static_cast<T*>(gb),
        bank_stride, out_stride, H, N, Dh, P_loc, cmax,
        cmax < 64 ? cmax : 64, (P_loc + kZeroRows - 1) / kZeroRows, scale,
        vec};
    // the faster of the variants measured on the H100 (PERF.md, Findings)
    return Dh > 64 ? launch_one<T, 2, 1, 1, 1, 2>(a, B, s)
                   : launch_one<T, 1, 2, 2, 2, 2>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}
