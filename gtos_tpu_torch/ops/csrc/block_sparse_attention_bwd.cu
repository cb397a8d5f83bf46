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
// encoder stack): a warp per (bank row, head) for rows with few pairs, and
// for rows with many (the global node's, the self path's) a block of 32
// warps that split the row's pairs in 32 contiguous parts and add the parts
// in a fixed order. No atomics in any of the three: the same bits on every
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;         // a B6d / B6s block: 8 warps
constexpr int kPassWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kMaxDPL = kMaxDh / 32;  // head dims per lane (B6b)
constexpr int kBankWarps = 32;        // warps of a B6b block

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

// 8 values of a row as read (16 bytes of bf16, 32 bytes of f32)
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { uint4 u; };
template <> struct Chunk<float> { float4 a, b; };

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           Chunk<__nv_bfloat16>& c) {
  c.u = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_chunk(const float* p, Chunk<float>& c) {
  c.a = __ldg(reinterpret_cast<const float4*>(p));
  c.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c,
                                       float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.u);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 f = __bfloat1622float2(h[x]);
    o[2 * x] = f.x;
    o[2 * x + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Chunk<float>& c, float* o) {
  o[0] = c.a.x; o[1] = c.a.y; o[2] = c.a.z; o[3] = c.a.w;
  o[4] = c.b.x; o[5] = c.b.y; o[6] = c.b.z; o[7] = c.b.w;
}

// The arrays of one pass. B6d: own1/own2 = q/gp, x1/x2 = k/v, own_bank =
// b_bank, part_bank = a_bank, tiles/rels = tile_src/tile_rel, row_base the
// first dst-major pair id of each plane row, dst2src each id's src-major
// place; it writes out1 = dq, ge [H, E] and pair_s [H, E, 2]. B6s: x1/x2 =
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
        if constexpr (kDst) {
          t4v[uu] = __ldg(a.t4 + static_cast<size_t>(r) * H + h);
          sid[uu] = __ldg(a.dst2src + id[uu]);
        } else {
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
        if (ok && li == 0) {
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
  const unsigned lt = (1u << lane) - 1u;
  for (int s0 = 0; s0 < a.Smax; s0 += warps) {
    // warp w: slot s0 + w, its tile id, plane row and first id at once
    const int s = s0 + warp;
    int other = -1, rank0 = 0;
    int4 rv = make_int4(-1, -1, -1, -1);
    if (s < a.Smax) {
      const size_t plane_row = (tile_row * a.Smax + s) * kTile + nl;
      other = __ldg(a.tiles + tile_row * a.Smax + s);
      rv = __ldg(reinterpret_cast<const int4*>(a.rels + plane_row * kTile) +
                 lane);
      rank0 = __ldg(a.row_base + plane_row);
    }
    const int rs[4] = {rv.x, rv.y, rv.z, rv.w};
    unsigned bits = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool keep = other >= 0 && rs[u] >= 0 && rs[u] < a.P &&
                        other * kTile + 4 * lane + u < N;
      bits |= static_cast<unsigned>(keep) << u;
    }
    int pos = 0, total = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, (bits >> u) & 1u);
      pos += __popc(m & lt);
      total += __popc(m);
    }
    if (lane == 0) counts[warp] = total;
    __syncthreads();
    // the slots' lists one after the other, in slot order
    int off = 0, all = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = counts[w];
      off += w < warp ? c : 0;
      all += c;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if ((bits >> u) & 1u) {
        list_o[off + pos] = other * kTile + 4 * lane + u;
        list_r[off + pos] = rs[u];
        list_id[off + pos] = rank0 + pos;
        ++pos;
      }
    }
    __syncthreads();
    if (active)
      for (int x0 = 0; x0 < all; x0 += kRound) take(x0, min(kRound, all - x0));
    __syncthreads();  // the list is rewritten for the next slots
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

// B6b: the bank gradients. The kept pairs sorted by bank row (stable):
// pair id `pid`, and the rows of q (b*N + i) and k (b*N + j) it reads; the
// sorted order splits into runs of one bank row, run x = [run_start[x],
// run_start[x + 1]) with row run_r[x]. Blocks [0, n_long * H): one per
// (long run, head), 32 warps over 32 contiguous parts of the run, the parts
// added in order; then blocks of 32 warps, a warp per (short run, head).
// Rows no pair references stay as the caller zeroed them.
template <typename T>
__global__ void __launch_bounds__(kBankWarps * 32)
blk_bank_grads(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ a_bank, const T* __restrict__ b_bank,
               const float* __restrict__ ge, const int32_t* __restrict__ pid,
               const int32_t* __restrict__ qrow,
               const int32_t* __restrict__ krow,
               const int32_t* __restrict__ run_r,
               const int32_t* __restrict__ run_start,
               const int32_t* __restrict__ long_runs, int n_long,
               const int32_t* __restrict__ short_runs, int n_short,
               T* __restrict__ g_a, T* __restrict__ g_b, int H, int N,
               int Dh, int E) {
  __shared__ float part[kBankWarps][2 * kMaxDh + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool is_long = blockIdx.x < static_cast<unsigned>(n_long * H);
  int run, h, lo, hi;
  if (is_long) {
    run = long_runs[blockIdx.x / H];
    h = blockIdx.x % H;
    const int s0 = run_start[run], len = run_start[run + 1] - s0;
    const int per = (len + kBankWarps - 1) / kBankWarps;
    lo = min(s0 + warp * per, s0 + len);
    hi = min(lo + per, s0 + len);
  } else {
    const int item = (blockIdx.x - n_long * H) * kBankWarps + warp;
    if (item >= n_short * H) return;  // short blocks have no barrier
    run = short_runs[item / H];
    h = item % H;
    lo = run_start[run];
    hi = run_start[run + 1];
  }
  float sq[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
  float sk[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
  float dt4 = 0.f;
  for (int base = lo; base < hi; base += 32) {
    // 32 pairs' indices at once, then the pairs in order
    const int x = base + lane;
    int p_id = 0, qr = 0, kr = 0;
    if (x < hi) {
      p_id = __ldg(pid + x);
      qr = __ldg(qrow + x);
      kr = __ldg(krow + x);
    }
    const float w = x < hi ? round_to<T>(ge[static_cast<size_t>(h) * E + p_id])
                           : 0.f;
    const int n = min(32, hi - base);
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float wc = __shfl_sync(0xffffffffu, w, c);
      const int qc = __shfl_sync(0xffffffffu, qr, c);
      const int kc = __shfl_sync(0xffffffffu, kr, c);
      const int bq = qc / N, bk = kc / N;
      const T* qp =
          q + ((static_cast<size_t>(bq) * H + h) * N + (qc - bq * N)) * Dh;
      const T* kp =
          k + ((static_cast<size_t>(bk) * H + h) * N + (kc - bk * N)) * Dh;
      dt4 += wc;
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) {
          sq[t] += wc * to_f32(qp[d]);
          sk[t] += wc * to_f32(kp[d]);
        }
      }
    }
  }
  const int r = run_r[run];
  const size_t row = (static_cast<size_t>(r) * H + h) * Dh;
  if (is_long) {
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        part[warp][d] = sq[t];
        part[warp][kMaxDh + d] = sk[t];
      }
    }
    if (lane == 0) part[warp][2 * kMaxDh] = dt4;
    __syncthreads();
    if (warp != 0) return;
    dt4 = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxDPL; ++t) sq[t] = sk[t] = 0.f;
    for (int w = 0; w < kBankWarps; ++w) {
      dt4 += part[w][2 * kMaxDh];
#pragma unroll
      for (int t = 0; t < kMaxDPL; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) {
          sq[t] += part[w][d];
          sk[t] += part[w][kMaxDh + d];
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxDPL; ++t) {
    const int d = lane + 32 * t;
    if (d < Dh) {
      g_b[row + d] = from_f32<T>(sq[t] + dt4 * to_f32(a_bank[row + d]));
      g_a[row + d] = from_f32<T>(sk[t] + dt4 * to_f32(b_bank[row + d]));
    }
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

template <typename T>
int launch_bank(const void* q, const void* k, const void* a_bank,
                const void* b_bank, const void* ge, const void* pid,
                const void* qrow, const void* krow, const void* run_r,
                const void* run_start, const void* long_runs, int n_long,
                const void* short_runs, int n_short, void* g_a, void* g_b,
                int H, int N, int Dh, int E, cudaStream_t stream) {
  const int blocks =
      n_long * H + (n_short * H + kBankWarps - 1) / kBankWarps;
  if (blocks == 0) return 0;  // no kept pair: the zeroed gradients stand
  blk_bank_grads<T><<<blocks, kBankWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(a_bank), static_cast<const T*>(b_bank),
      static_cast<const float*>(ge), static_cast<const int32_t*>(pid),
      static_cast<const int32_t*>(qrow), static_cast<const int32_t*>(krow),
      static_cast<const int32_t*>(run_r),
      static_cast<const int32_t*>(run_start),
      static_cast<const int32_t*>(long_runs), n_long,
      static_cast<const int32_t*>(short_runs), n_short, static_cast<T*>(g_a),
      static_cast<T*>(g_b), H, N, Dh, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, the banks, gp and the
// gradients). All tensors contiguous on one device: q, k, v, gp [B, H, N,
// Dh] (16-byte aligned); a_bank, b_bank [P, H, Dh] (16-byte aligned); t4
// [P, H] float32 (a_r.b_r rounded to the bank type); m, l, delta [B, H, N]
// float32; pair_s [H, E, 2] float32, each kept pair's (ge, p) at its
// src-major place; Dh a multiple of 8, at most 128. Each returns the CUDA
// error code of its launch (0 = launched).

// B6d: tile_src [B, Td, Smax], tile_rel [B, Td, Smax, 128, 128] int32;
// row_base [B, Td, Smax, 128] int32, the id of each plane row's first kept
// pair (E kept pairs in all); dst2src [E] int32, each id's src-major place;
// writes dq [B, H, N, Dh], ge [H, E] float32 and pair_s.
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

// Forces the bf16 variant v in [0, kVariants) of B6d and B6s for rows up to
// 64 wide (any other v: each kernel's own); returns kVariants (0 unless
// built with GTOS_B6_VARIANTS).
extern "C" int gtos_blk_attn_bwd_variant(int v) {
  g_forced_variant = v >= 0 && v < kVariants ? v : -1;
  return kVariants;
}

// B6b: ge [H, E] float32 from B6d; pid, qrow, krow [E] int32 (the pairs in
// bank-row order: pair id, b*N + i, b*N + j); run_r [R], run_start [R + 1]
// int32; long_runs [n_long], short_runs [n_short] int32 run indices; g_a,
// g_b [P, H, Dh], zeroed by the caller.
extern "C" int gtos_blk_bank_grads(int dtype, const void* q, const void* k,
                                   const void* a_bank, const void* b_bank,
                                   const void* ge, const void* pid,
                                   const void* qrow, const void* krow,
                                   const void* run_r, const void* run_start,
                                   const void* long_runs, int n_long,
                                   const void* short_runs, int n_short,
                                   void* g_a, void* g_b, int H, int N, int Dh,
                                   int E, void* stream) {
  if (H < 1 || N < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 || E < 0 ||
      n_long < 0 || n_short < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bank<float>(q, k, a_bank, b_bank, ge, pid, qrow, krow,
                              run_r, run_start, long_runs, n_long, short_runs,
                              n_short, g_a, g_b, H, N, Dh, E, s);
  if (dtype == 1)
    return launch_bank<__nv_bfloat16>(q, k, a_bank, b_bank, ge, pid, qrow,
                                      krow, run_r, run_start, long_runs,
                                      n_long, short_runs, n_short, g_a, g_b,
                                      H, N, Dh, E, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
