// Block-sparse relation-aware attention, backward, for Hopper (sm_90a):
// three kernels.
//
// Replaces: gtos_tpu/ops/pallas/block_sparse_attention_bwd.py
//   B6d `_bwd_dst_kernel` (wrapper `block_sparse_attention_bwd_dst`): the
//       dst-major pass: dq, and ge for the bank gradients;
//   B6s `_bwd_src_kernel` (wrapper `block_sparse_attention_bwd_src`): the
//       src-major pass over the transposed tile layout: dk and dv;
//   B6b the bank gradients, which the TPU kernels sum in their constant-
//       index g_bb/g_ab output blocks, with finish_bank_grads's t4 term
//       (wrapper `block_sparse_bank_grads`).
//
// For a kept pair (i <- j) with bank row r (the forward's pair set), head h,
// t4 [P, H] as the forward takes it, the forward's statistics m_i, l_i,
// delta_i = sum_d g_i out_i (out in v's
// type, g in f32) and gp = g rounded to the input type:
//   e_ij  = (q_i.k_j + q_i.b_r + t4_r + k_j.a_r) * scale    as the forward
//   p_ij  = exp(e_ij - m_i) / l_i,  dp_ij = gp_i.v_j,
//   ge_ij = p_ij (dp_ij - delta_i) * scale                   (f32)
//   dq_i  = sum_j ge'_ij (k_j + b_r)      dk_j = sum_i ge'_ij (q_i + a_r)
//   dv_j  = sum_i p'_ij gp_i
//   g_a[r] = sum ge' k_j + dt4_r b_r,  g_b[r] = sum ge' q_i + dt4_r a_r,
//   dt4_r = sum ge'   (over the kept pairs with bank row r, every graph)
// with ge' and p' rounded to the input type (the TPU kernels' MXU operands),
// every sum in f32, dq/dk/dv in the input type and g_a/g_b in the bank type.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): per
// kept pair and head about 12 Dh multiply-adds over the three kernels,
// against the bytes of q, k, v, gp, the statistics, the tile planes, the
// referenced bank rows, ge and the outputs: the bytes bound it. What holds
// B6d and B6s above it is the latency of their gathers: each kept pair
// reads its partner's rows and its bank rows from L2, rows that differ
// from pair to pair, and a 128x128 block keeps 2-10% of its pairs at the
// c5 model's 4 hops, too few to reuse a staged partner row.
//
// B6d and B6s: one template, `blk_attn_bwd_pass`. The "own" node is the
// one whose gradient the pass writes (B6d: the dst node i; B6s: the src
// node j), the "partner" the other end of each pair (B6d: rows k and v;
// B6s: q and gp). A block per own node and up to 8 heads, a warp a head:
//   - the planes are read once for all heads: each warp reads the tile id
//     and the plane row of one slot (8 slots in one round trip), compacts
//     its kept pairs by ballot into a list in shared memory (partner,
//     bank row, pair id), and after a barrier every warp walks the whole
//     list for its head;
//   - a warp takes the list in rounds: 4 groups of 8 lanes, a group
//     holding kGu pairs and each lane reading its 16-byte chunks of a
//     pair's rows all at once, so a round costs one round trip; the rows
//     stay in registers for all their uses; the 4 groups' sums add in a
//     fixed butterfly at the end;
//   - B6d scores each pair (q.k + q.b + k.a + t4, gp.v: its own rows q
//     and gp in registers), adds ge' (k_j + b_r) into dq, writes ge at the
//     pair's dst-major id (row_base + rank in the plane row, the order B6b
//     reads) and (ge, p) at its src-major place (dst2src[id]);
//   - B6s reads (ge, p) at its own pairs' places, which follow the src-
//     major planes (row_base there + rank), and only gathers q_i, gp_i and
//     a_r: ge' (q_i + a_r) into dk, p' gp_i into dv. No score, no softmax
//     statistics, no b_r.
// kGu and the registers a thread may hold trade the round trips in flight
// per warp against the warps per SM.
// The design that stages each slot's partner tile in shared memory and
// runs the block's content products on the tensor cores (mma.sync) was
// built and measured on the H100 and was slower at every density tried
// (2-99% of a block's pairs kept; PERF.md, Findings): at the c5
// model's 2-10% a staged partner row serves one or two pairs, and the
// block's barrier-separated phases, each a round trip, set the time.
//
// B6b reads the pairs sorted by bank row (a stable order built once per
// encoder stack by backward_plan on the card, with its work list). The
// plan's arrays are padded to a pair capacity fixed by the batch
// signature, so the launches are too: the grid is sized from the work
// list's bounds, each block reads the list's counts from device memory and
// a block past them returns at once, and the combine launch is always
// issued (with no run of several chunks its blocks all return). The run of one bank
// row is walked once for all heads: a block of up to 8 head warps stages
// the pairs' q and k row offsets and their ge' (ge rounded to the input
// type) for its heads in shared memory, and each head's warp gathers its
// q_i and k_j rows in 8-lane groups, 16 bytes a lane, several pairs a
// round trip. A run of at most 32 pairs (most runs at the c5 model's
// khop 4) is one group's: a block walks 4 of them, the runs sorted
// longest first, and writes their rows. A longer run is cut into chunks of
// 256 pairs, a block each, whose 4 groups share the chunk and add their
// sums in a fixed butterfly; a run of several chunks has each chunk's sums
// written to a workspace, added in chunk order by a second, small launch.
// Further blocks write the rows no pair references as 0, so every row of
// g_a and g_b is written once and the caller fills nothing. No atomics in
// any of the three kernels: the same bits on every run.

#include <math.h>

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kThreads = 256;         // a block: 8 warps
constexpr int kPassWarps = kThreads / 32;
constexpr int kShortRun = 32;         // B6b: runs a lane group takes whole
constexpr int kChunk = 256;           // B6b: a longer run's pairs a block
constexpr int kZeroRows = 64;         // B6b: unreferenced rows a block

// The arrays of one pass. B6d: own1/own2 = q/gp, x1/x2 = k/v, own_bank =
// b_bank, part_bank = a_bank, tiles/rels = tile_src/tile_rel, row_base the
// first dst-major pair id of each plane row, dst2src each id's src-major
// place; it writes out1 = dq, ge [H, E] and pair_s [H, E, 2] (E: the
// plan's pair capacity, their row stride; only the kept pairs' entries are
// written). B6s: x1/x2 =
// q/gp, own_bank = a_bank, tiles/rels = tile_dst/tile_rel_src, row_base the
// first src-major place of each plane row; it reads pair_s and writes out1
// = dk, out2 = dv. The pointers a pass does not use are null.
template <typename T> struct PassArgs {
  const T* own1; const T* own2; const T* x1; const T* x2;
  const T* own_bank; const T* part_bank;
  const float* t4; const float* m; const float* l; const float* delta;
  const int32_t* tiles; const int32_t* rels; const int32_t* row_base;
  const int32_t* dst2src;
  float* pair_s;
  T* out1; T* out2; float* ge;
  int H, N, Dh, P, Tn, Smax, E;
  float scale;
};

// One pass (B6d: kDst; B6s: !kDst): the block of own node blockIdx.x of
// graph blockIdx.z, warp w the head blockIdx.y * 8 + w (warps past H only
// help read the planes); a lane holds kCpl 16-byte chunks of a row (Dh up
// to 64 kCpl).
template <typename T, bool kDst, int kCpl, int kGu, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blk_attn_bwd_pass(const PassArgs<T> a) {
  constexpr int kGl = 8;                       // lanes per pair
  constexpr int kGroups = 32 / kGl;
  constexpr int kRound = kGroups * kGu;        // pairs a warp holds
  constexpr int kList = kPassWarps * kTile;    // pairs of 8 plane rows
  __shared__ int list_o[kList];    // partner node
  __shared__ int list_r[kList];    // bank row
  __shared__ int list_id[kList];   // B6d: dst-major id; B6s: place
  __shared__ int counts[kPassWarps];

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, E = a.E;
  const int h = blockIdx.y * kPassWarps + warp;
  const bool active = h < H;
  const int grp = lane / kGl, li = lane % kGl;
  const int C = Dh / 8;
  const size_t bh = static_cast<size_t>(b) * H + (active ? h : 0);
  const size_t head = bh * N * Dh;
  const size_t own_row = head + static_cast<size_t>(n) * Dh;

  Chunk<T> o1[kCpl], o2[kCpl];
  float m_own = 0.f, l_own = 1.f, d_own = 0.f;
  if constexpr (kDst) {
    if (active) {
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = li + kGl * cc;
        if (c < C) {
          load_chunk(a.own1 + own_row + c * 8, o1[cc]);
          load_chunk(a.own2 + own_row + c * 8, o2[cc]);
        }
      }
      m_own = a.m[bh * N + n];
      l_own = a.l[bh * N + n] > 0.f ? a.l[bh * N + n] : 1.f;
      d_own = a.delta[bh * N + n];
    }
  }
  float acc1[kCpl * 8], acc2[kCpl * 8];
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) acc1[x] = acc2[x] = 0.f;

  // pairs [x0, x0 + cnt) of the list, kGu a group
  auto take = [&](int x0, int cnt) {
    Chunk<T> xa[kGu][kCpl], ya[kGu][kCpl], ob[kGu][kCpl], pb[kGu][kCpl];
    float t4v[kGu], gev[kGu], pv[kGu];
    int id[kGu], sid[kGu];
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int x = grp + kGroups * uu;
      t4v[uu] = gev[uu] = pv[uu] = 0.f;
      id[uu] = sid[uu] = 0;
      if (x < cnt) {
        const int o = list_o[x0 + x], r = list_r[x0 + x];
        id[uu] = list_id[x0 + x];
        const size_t orow = head + static_cast<size_t>(o) * Dh;
        const size_t row = (static_cast<size_t>(r) * H + h) * Dh;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C) {
            load_chunk(a.x1 + orow + c * 8, xa[uu][cc]);
            load_chunk(a.x2 + orow + c * 8, ya[uu][cc]);
            load_chunk(a.own_bank + row + c * 8, ob[uu][cc]);
            if constexpr (kDst)
              load_chunk(a.part_bank + row + c * 8, pb[uu][cc]);
          }
        }
        // an id or place past the capacity E (a plan whose `ok` flag is
        // false) is neither read nor written
        if constexpr (kDst) {
          t4v[uu] = __ldg(a.t4 + static_cast<size_t>(r) * H + h);
          sid[uu] = id[uu] < E ? __ldg(a.dst2src + id[uu]) : E;
        } else if (id[uu] < E) {
          const float2 s = __ldg(reinterpret_cast<const float2*>(a.pair_s) +
                                 static_cast<size_t>(h) * E + id[uu]);
          gev[uu] = s.x;
          pv[uu] = s.y;
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const bool ok = grp + kGroups * uu < cnt;
      if constexpr (kDst) {
        float s1 = 0.f, dp = 0.f;
        if (ok) {
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float w1[8], w2[8], x8[8], y8[8], a8[8], b8[8];
              unpack(o1[cc], w1);
              unpack(o2[cc], w2);
              unpack(xa[uu][cc], x8);
              unpack(ya[uu][cc], y8);
              unpack(ob[uu][cc], a8);
              unpack(pb[uu][cc], b8);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                s1 += w1[e] * (x8[e] + a8[e]) + x8[e] * b8[e];
                dp += w2[e] * y8[e];
              }
            }
          }
        }
#pragma unroll
        for (int off = 1; off < kGl; off <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          dp += __shfl_xor_sync(0xffffffffu, dp, off);
        }
        pv[uu] = expf((s1 + t4v[uu]) * a.scale - m_own) / l_own;
        gev[uu] = pv[uu] * (dp - d_own) * a.scale;
        if (ok && li == 0 && id[uu] < E && sid[uu] < E) {
          a.ge[static_cast<size_t>(h) * E + id[uu]] = gev[uu];
          reinterpret_cast<float2*>(a.pair_s)[static_cast<size_t>(h) * E +
                                              sid[uu]] =
              make_float2(gev[uu], pv[uu]);
        }
      }
      if (ok) {
        const float gq = round_to<T>(gev[uu]), pq = round_to<T>(pv[uu]);
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float x8[8], y8[8], a8[8];
            unpack(xa[uu][cc], x8);
            unpack(ya[uu][cc], y8);
            unpack(ob[uu][cc], a8);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc1[cc * 8 + e] += gq * (x8[e] + a8[e]);
              if constexpr (!kDst) acc2[cc * 8 + e] += pq * y8[e];
            }
          }
        }
      }
    }
  };

  const int t = n / kTile, nl = n - t * kTile;
  const size_t tile_row = static_cast<size_t>(b) * a.Tn + t;
  for (int s0 = 0; s0 < a.Smax; s0 += warps) {
    const int all = plane_round(a.tiles, a.rels, a.row_base, tile_row, nl,
                                s0, a.Smax, a.P, N, counts, list_o, list_r,
                                list_id);
    if (active)
      for (int x0 = 0; x0 < all; x0 += kRound) take(x0, min(kRound, all - x0));
    __syncthreads();  // the lists are rewritten for the next slots
  }
  if (!active) return;

  // the 4 groups' sums, in a fixed butterfly; group 0 writes the row
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) {
#pragma unroll
    for (int off = kGl; off < 32; off <<= 1) {
      acc1[x] += __shfl_xor_sync(0xffffffffu, acc1[x], off);
      if constexpr (!kDst)
        acc2[x] += __shfl_xor_sync(0xffffffffu, acc2[x], off);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a.out1[own_row + c * 8 + e] = from_f32<T>(acc1[cc * 8 + e]);
          if constexpr (!kDst)
            a.out2[own_row + c * 8 + e] = from_f32<T>(acc2[cc * 8 + e]);
        }
      }
    }
  }
}

// B6b: the bank gradients, from the pairs in bank-row order (stable): for
// sorted place x, `pid[x]` the pair's id (its column in ge), `qrow[x]` and
// `krow[x]` its q and k rows (b*N + i, b*N + j). Work items, int4 each:
// chunks (first place, pairs <= 256, bank row, workspace slot or -1 for a
// run of one chunk), the longer runs' pieces; shorts (first place, pairs
// <= 32, bank row, 0), whole runs, longest first; multi (first slot,
// slots, bank row, 0), the runs of several chunks. Each list holds
// *_cap entries, of which counts[0], counts[1] and counts[2] (device
// memory) are real. used [P]: 0 for a row no pair references.
template <typename T> struct BankArgs {
  const T* q; const T* k; const T* a_bank; const T* b_bank; const float* ge;
  const int32_t* pid; const int32_t* qrow; const int32_t* krow;
  const int4* chunks; const int4* shorts; const int4* multi;
  const int32_t* counts;
  const uint8_t* used;
  float* part;   // [slots, H, 2 Dh + 4] f32: a chunk's sums of ge' q, ge' k
                 // and ge' (at 2 Dh)
  T* g_a; T* g_b;
  int H, N, Dh, E, P, chunk_cap, short_cap, multi_cap;
};

// the bank row r of head h from its sums: g_b = sq + dt4 a_r and g_a =
// sk + dt4 b_r; a group's lane li writes its chunks
template <typename T, int kCpl>
__device__ __forceinline__ void write_bank_row(const BankArgs<T>& a, int r,
                                               int h, int li, const float* sq,
                                               const float* sk, float dt4) {
  const size_t row = (static_cast<size_t>(r) * a.H + h) * a.Dh;
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    const int c = li + 8 * cc;
    if (c < a.Dh / 8) {
      Chunk<T> ac, bc;
      load_chunk(a.a_bank + row + c * 8, ac);
      load_chunk(a.b_bank + row + c * 8, bc);
      float a8[8], b8[8], ob[8], oa[8];
      unpack(ac, a8);
      unpack(bc, b8);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        ob[d] = sq[cc * 8 + d] + dt4 * a8[d];
        oa[d] = sk[cc * 8 + d] + dt4 * b8[d];
      }
      store8(a.g_b + row + c * 8, ob);
      store8(a.g_a + row + c * 8, oa);
    }
  }
}

// Blocks [0, chunk_cap): a chunk each, those past counts[0] idle; then
// blocks of 4 short runs (short_cap runs, those past counts[1] idle);
// then (head block 0 only) blocks of kZeroRows rows that write the
// unreferenced rows as 0. Warp w is head blockIdx.y * 8 + w (warps past H
// only stage). E: ge's row stride, the plan's pair capacity.
template <typename T, int kCpl, int kGu, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blk_bank_grads(const BankArgs<T> a) {
  constexpr int kGl = 8;                       // lanes per pair
  constexpr int kGroups = 32 / kGl;
  __shared__ int s_q[kChunk];                  // b*H*N + i
  __shared__ int s_k[kChunk];                  // b*H*N + j
  __shared__ float s_w[kPassWarps][kChunk];    // ge' per head
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int H = a.H, N = a.N, Dh = a.Dh, C = Dh / 8;
  const int h0 = blockIdx.y * kPassWarps;
  const int h = h0 + warp;
  const int n_heads = min(warps, H - h0);
  const int bx = blockIdx.x;
  const int short_blocks = (a.short_cap + kGroups - 1) / kGroups;
  const bool is_chunk = bx < a.chunk_cap;
  const int n_chunks = __ldg(a.counts), n_short = __ldg(a.counts + 1);

  if (bx >= a.chunk_cap + short_blocks) {   // unreferenced rows: 0
    if (blockIdx.y != 0) return;
    const int r0 = (bx - a.chunk_cap - short_blocks) * kZeroRows;
    const int vecs = H * Dh * static_cast<int>(sizeof(T)) / 16;
    for (int x = threadIdx.x; x < kZeroRows * vecs; x += blockDim.x) {
      const int r = r0 + x / vecs;
      if (r < a.P && a.used[r] == 0) {
        const size_t at = static_cast<size_t>(r) * vecs + x % vecs;
        reinterpret_cast<uint4*>(a.g_a)[at] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(a.g_b)[at] = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  // past the list's real entries: nothing to do (the whole block)
  if (is_chunk ? bx >= n_chunks
               : (bx - a.chunk_cap) * kGroups >= n_short)
    return;

  // stage the block's pairs: slot s of a chunk is its pair s; slot s of a
  // block of short runs is pair s % 32 of run s / 32
  int4 item = make_int4(0, 0, 0, 0);   // this thread's slot's chunk or run
  const int slots = is_chunk ? kChunk : kGroups * kShortRun;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    int x = s;
    if (is_chunk) {
      item = a.chunks[bx];
    } else {
      const int run = (bx - a.chunk_cap) * kGroups + s / kShortRun;
      item = run < n_short ? a.shorts[run] : make_int4(0, 0, 0, 0);
      x = s % kShortRun;
    }
    if (x < item.y) {
      const int p = item.x + x;
      const int id = __ldg(a.pid + p), qr = __ldg(a.qrow + p),
                kr = __ldg(a.krow + p);
      const int bq = qr / N, bk = kr / N;
      s_q[s] = bq * H * N + (qr - bq * N);
      s_k[s] = bk * H * N + (kr - bk * N);
      for (int hh = 0; hh < n_heads; ++hh)
        s_w[hh][s] = round_to<T>(
            __ldg(a.ge + static_cast<size_t>(h0 + hh) * a.E + id));
    }
  }
  __syncthreads();
  if (h >= H) return;   // no barrier below

  float sq[kCpl * 8], sk[kCpl * 8], dt4 = 0.f;
#pragma unroll
  for (int x = 0; x < kCpl * 8; ++x) sq[x] = sk[x] = 0.f;
  const float* w = s_w[warp];
  // slots [x0, x0 + kGu * step) by kGu, step apart, below `end`
  auto take = [&](int x0, int step, int end) {
    Chunk<T> qc[kGu][kCpl], kc[kGu][kCpl];
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int x = x0 + step * uu;
      if (x < end) {
        const size_t qo = (static_cast<size_t>(s_q[x]) + static_cast<size_t>(h) * N) * Dh;
        const size_t ko = (static_cast<size_t>(s_k[x]) + static_cast<size_t>(h) * N) * Dh;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = li + kGl * cc;
          if (c < C) {
            load_chunk(a.q + qo + c * 8, qc[uu][cc]);
            load_chunk(a.k + ko + c * 8, kc[uu][cc]);
          }
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kGu; ++uu) {
      const int x = x0 + step * uu;
      if (x < end) {
        const float wx = w[x];
        dt4 += wx;
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          if (li + kGl * cc < C) {
            float q8[8], k8[8];
            unpack(qc[uu][cc], q8);
            unpack(kc[uu][cc], k8);
#pragma unroll
            for (int d = 0; d < 8; ++d) {
              sq[cc * 8 + d] += wx * q8[d];
              sk[cc * 8 + d] += wx * k8[d];
            }
          }
        }
      }
    }
  };

  if (!is_chunk) {
    // group g: short run g of the block, whole, kGu pairs a round trip
    const int run = (bx - a.chunk_cap) * kGroups + grp;
    if (run >= n_short) return;
    const int4 it = a.shorts[run];
    const int base = grp * kShortRun;
    for (int x0 = 0; x0 < it.y; x0 += kGu) take(base + x0, 1, base + it.y);
    write_bank_row<T, kCpl>(a, it.z, h, li, sq, sk, dt4);
    return;
  }
  // a chunk: its pairs over the 4 groups, then their sums in a fixed
  // butterfly
  const int4 it = a.chunks[bx];
  for (int x0 = 0; x0 < it.y; x0 += kGroups * kGu)
    take(x0 + grp, kGroups, it.y);
#pragma unroll
  for (int off = kGl; off < 32; off <<= 1) {
    dt4 += __shfl_xor_sync(0xffffffffu, dt4, off);
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) {
      sq[x] += __shfl_xor_sync(0xffffffffu, sq[x], off);
      sk[x] += __shfl_xor_sync(0xffffffffu, sk[x], off);
    }
  }
  if (grp != 0) return;
  if (it.w < 0) {   // the run's only chunk
    write_bank_row<T, kCpl>(a, it.z, h, li, sq, sk, dt4);
    return;
  }
  float* part = a.part + (static_cast<size_t>(it.w) * H + h) * (2 * Dh + 4);
#pragma unroll
  for (int cc = 0; cc < kCpl; ++cc) {
    const int c = li + kGl * cc;
    if (c < C) {
      store8(part + c * 8, sq + cc * 8);
      store8(part + Dh + c * 8, sk + cc * 8);
    }
  }
  if (li == 0) part[2 * Dh] = dt4;
}

// B6b's second launch: a block per entry of `multi` (warp w: head
// blockIdx.y * 8 + w; the blocks past counts[2] idle) adds the chunks'
// sums of its run in chunk order and writes the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
blk_bank_combine(const BankArgs<T> a) {
  constexpr int kVals = 2 * kMaxDh / 32;   // sums a lane adds
  const int h = blockIdx.y * kPassWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= a.H || static_cast<int>(blockIdx.x) >= __ldg(a.counts + 2))
    return;
  const int Dh = a.Dh, width = 2 * Dh + 4;
  const int4 it = a.multi[blockIdx.x];
  float s[kVals], dt4 = 0.f;
#pragma unroll
  for (int t = 0; t < kVals; ++t) s[t] = 0.f;
  // kInFlight chunks' sums read at once, then added in chunk order
  constexpr int kInFlight = 8;
  for (int s0 = it.x; s0 < it.x + it.y; s0 += kInFlight) {
    float v[kInFlight][kVals], d[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const float* part =
          a.part + (static_cast<size_t>(s0 + u) * a.H + h) * width;
      const bool ok = s0 + u < it.x + it.y;
#pragma unroll
      for (int t = 0; t < kVals; ++t)
        v[u][t] = ok && lane + 32 * t < 2 * Dh ? __ldg(part + lane + 32 * t)
                                               : 0.f;
      d[u] = ok ? __ldg(part + 2 * Dh) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
      for (int t = 0; t < kVals; ++t) s[t] += v[u][t];
      dt4 += d[u];
    }
  }
  const size_t row = (static_cast<size_t>(it.z) * a.H + h) * Dh;
#pragma unroll
  for (int t = 0; t < kVals; ++t) {
    const int d = lane + 32 * t;
    if (d < Dh)
      a.g_b[row + d] = from_f32<T>(s[t] + dt4 * to_f32(a.a_bank[row + d]));
    else if (d < 2 * Dh)
      a.g_a[row + d - Dh] =
          from_f32<T>(s[t] + dt4 * to_f32(a.b_bank[row + d - Dh]));
  }
}

bool bad_sizes(int B, int H, int N, int Dh, int P, int Tn, int Smax) {
  return B < 1 || H < 1 || N < 1 || N > Tn * kTile || Dh < 8 ||
         Dh > kMaxDh || Dh % 8 != 0 || P < 1 || Smax < 1;
}

#ifdef GTOS_B6_VARIANTS
constexpr int kVariants = 4;
#else
constexpr int kVariants = 0;
#endif
int g_forced_variant = -1;

template <typename T, bool kDst, int kCpl, int kGu, int kMinBlocks>
int launch_one(const PassArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid(a.N, (a.H + kPassWarps - 1) / kPassWarps, B);
  const int threads = 32 * (a.H < kPassWarps ? a.H : kPassWarps);
  blk_attn_bwd_pass<T, kDst, kCpl, kGu, kMinBlocks>
      <<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 pass for rows up to 64 wide: B6d 1 pair a group at 3 blocks an
// SM, B6s 2 pairs a group at 3 blocks an SM, the fastest on the H100 of
// four (kGu, kMinBlocks) variants over the c5 model's train batches.
// Built with GTOS_B6_VARIANTS, the source also holds the four, and
// gtos_blk_attn_bwd_variant forces one (chip_b6_variants.py --variants).
template <typename T, bool kDst>
int launch_pass(const PassArgs<T>& a, int B, cudaStream_t stream) {
  if (a.Dh > 64) return launch_one<T, kDst, 2, 1, 1>(a, B, stream);
  if constexpr (sizeof(T) != 2) {
    return launch_one<T, kDst, 1, 2, 1>(a, B, stream);
  } else {
#ifdef GTOS_B6_VARIANTS
    switch (g_forced_variant) {
      case 0: return launch_one<T, kDst, 1, 1, 3>(a, B, stream);
      case 1: return launch_one<T, kDst, 1, 2, 2>(a, B, stream);
      case 2: return launch_one<T, kDst, 1, 2, 3>(a, B, stream);
      case 3: return launch_one<T, kDst, 1, 4, 2>(a, B, stream);
    }
#endif
    return launch_one<T, kDst, 1, kDst ? 1 : 2, 3>(a, B, stream);
  }
}

template <typename T, int kCpl, int kGu, int kMinBlocks>
int launch_bank_one(const BankArgs<T>& a, cudaStream_t stream) {
  const int blocks = a.chunk_cap + (a.short_cap + 3) / 4 +
                     (a.P + kZeroRows - 1) / kZeroRows;
  const dim3 grid(blocks, (a.H + kPassWarps - 1) / kPassWarps);
  const int threads = 32 * (a.H < kPassWarps ? a.H : kPassWarps);
  blk_bank_grads<T, kCpl, kGu, kMinBlocks><<<grid, threads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blk_bank_combine<T><<<dim3(a.multi_cap, grid.y), threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel for rows up to 64 wide: 4 pairs a group at 4 blocks an
// SM; under GTOS_B6_VARIANTS gtos_blk_attn_bwd_variant also forces one of
// four (kGu, kMinBlocks) variants here.
template <typename T>
int launch_bank(const BankArgs<T>& a, cudaStream_t stream) {
  if (a.Dh > 64) return launch_bank_one<T, 2, 2, 1>(a, stream);
  if constexpr (sizeof(T) != 2) {
    return launch_bank_one<T, 1, 2, 2>(a, stream);
  } else {
#ifdef GTOS_B6_VARIANTS
    switch (g_forced_variant) {
      case 0: return launch_bank_one<T, 1, 2, 4>(a, stream);
      case 1: return launch_bank_one<T, 1, 4, 3>(a, stream);
      case 2: return launch_bank_one<T, 1, 4, 4>(a, stream);
      case 3: return launch_bank_one<T, 1, 8, 2>(a, stream);
    }
#endif
    return launch_bank_one<T, 1, 4, 4>(a, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the banks, gp and the
// gradients). All tensors contiguous on one device: q, k, v, gp [B, H, N,
// Dh] (16-byte aligned); a_bank, b_bank [P, H, Dh] (16-byte aligned); t4
// [P, H] float32 (a_r.b_r rounded to the bank type); m, l, delta [B, H, N]
// float32; pair_s [H, E, 2] float32, each kept pair's (ge, p) at its
// src-major place (E: the plan's pair capacity, at least the kept pairs);
// Dh a multiple of 8, at most 128. Each returns the CUDA
// error code of its launch (0 = launched).

// B6d: tile_src [B, Td, Smax], tile_rel [B, Td, Smax, 128, 128] int32;
// row_base [B, Td, Smax, 128] int32, the id of each plane row's first kept
// pair; dst2src [E] int32, each id's src-major place; writes dq [B, H, N,
// Dh], and ge [H, E] float32 and pair_s at the kept pairs' ids and places.
extern "C" int gtos_blk_attn_bwd_dst(
    int dtype, const void* q, const void* k, const void* v,
    const void* a_bank, const void* b_bank, const void* t4, const void* gp,
    const void* m, const void* l, const void* delta, const void* tile_src,
    const void* tile_rel, const void* row_base, const void* dst2src,
    void* dq, void* ge, void* pair_s, int B, int H, int N, int Dh, int P,
    int Td, int Smax, int E, float scale, void* stream) {
  if (bad_sizes(B, H, N, Dh, P, Td, Smax) || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const PassArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(gp),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(b_bank), static_cast<const T*>(a_bank),
        static_cast<const float*>(t4), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(delta),
        static_cast<const int32_t*>(tile_src),
        static_cast<const int32_t*>(tile_rel),
        static_cast<const int32_t*>(row_base),
        static_cast<const int32_t*>(dst2src), static_cast<float*>(pair_s),
        static_cast<T*>(dq), nullptr, static_cast<float*>(ge),
        H, N, Dh, P, Td, Smax, E, scale};
    return launch_pass<T, true>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

// B6s: tile_dst [B, Ts, Smax_s], tile_rel_src [B, Ts, Smax_s, 128, 128]
// int32 (blocks transposed: [src-local, dst-local]); row_base [B, Ts,
// Smax_s, 128] int32, the src-major place of each plane row's first kept
// pair; pair_s from B6d; writes dk, dv [B, H, N, Dh].
extern "C" int gtos_blk_attn_bwd_src(
    int dtype, const void* q, const void* gp, const void* a_bank,
    const void* tile_dst, const void* tile_rel_src, const void* row_base,
    const void* pair_s, void* dk, void* dv, int B, int H, int N, int Dh,
    int P, int Ts, int Smax, int E, void* stream) {
  if (bad_sizes(B, H, N, Dh, P, Ts, Smax) || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const PassArgs<T> a{
        nullptr, nullptr, static_cast<const T*>(q),
        static_cast<const T*>(gp), static_cast<const T*>(a_bank), nullptr,
        nullptr, nullptr, nullptr, nullptr,
        static_cast<const int32_t*>(tile_dst),
        static_cast<const int32_t*>(tile_rel_src),
        static_cast<const int32_t*>(row_base), nullptr,
        const_cast<float*>(static_cast<const float*>(pair_s)),
        static_cast<T*>(dk), static_cast<T*>(dv), nullptr,
        H, N, Dh, P, Ts, Smax, E, 0.f};
    return launch_pass<T, false>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

// Forces the bf16 variant v in [0, kVariants) of B6d, B6s and B6b for rows
// up to 64 wide (any other v: each kernel's own); returns kVariants (0 unless
// built with GTOS_B6_VARIANTS).
extern "C" int gtos_blk_attn_bwd_variant(int v) {
  g_forced_variant = v >= 0 && v < kVariants ? v : -1;
  return kVariants;
}

// B6b: ge [H, E] float32 from B6d (E: the plan's pair capacity); pid,
// qrow, krow [E] int32 (the pairs in bank-row order: pair id, b*N + i,
// b*N + j; the real ones first); chunks [chunk_cap], shorts [short_cap],
// multi [multi_cap] int32x4 (16-byte aligned), counts [4] int32 (the real
// chunks, shorts, multi entries, and slots) and used [P] uint8,
// backward_plan's work list; part [slots, H, 2 Dh + 4] float32 scratch for
// the plan's slot bound; writes every row of g_a, g_b [P, H, Dh]. Returns
// the CUDA error code of its launches.
extern "C" int gtos_blk_bank_grads(
    int dtype, const void* q, const void* k, const void* a_bank,
    const void* b_bank, const void* ge, const void* pid, const void* qrow,
    const void* krow, const void* chunks, int chunk_cap, const void* shorts,
    int short_cap, const void* multi, int multi_cap, const void* counts,
    const void* used, void* part, void* g_a, void* g_b, int H, int N, int Dh,
    int E, int P, void* stream) {
  if (H < 1 || N < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 || E < 0 ||
      P < 1 || chunk_cap < 1 || short_cap < 1 || multi_cap < 1 ||
      counts == nullptr || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const BankArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(a_bank), static_cast<const T*>(b_bank),
        static_cast<const float*>(ge), static_cast<const int32_t*>(pid),
        static_cast<const int32_t*>(qrow), static_cast<const int32_t*>(krow),
        static_cast<const int4*>(chunks), static_cast<const int4*>(shorts),
        static_cast<const int4*>(multi), static_cast<const int32_t*>(counts),
        static_cast<const uint8_t*>(used), static_cast<float*>(part),
        static_cast<T*>(g_a), static_cast<T*>(g_b),
        H, N, Dh, E, P, chunk_cap, short_cap, multi_cap};
    return launch_bank<T>(a, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}
