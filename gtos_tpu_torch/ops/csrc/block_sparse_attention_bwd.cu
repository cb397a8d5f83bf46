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
// referenced bank rows, ge and the outputs: the bytes bound it.
//
// Design: the TPU kernels scatter ge into dense [T, H, P_pad] GT2/GT3 rows
// with one-hot matmuls and keep the bank gradients resident across the
// sequential grid; neither carries over to 132 SMs running blocks in no
// order. Here the dst-major pass (B6d, one warp per dst node, the forward's
// walk) accumulates dq in registers and writes each kept pair's ge (f32) at
// the pair's id: its rank in the dst-major order of the tile planes, from
// `row_base`. The src-major pass (B6s, one warp per src node) walks
// tile_dst/tile_rel_src the same way, recomputes p and ge and accumulates
// dk and dv. The bank pass (B6b) reads the pairs sorted by bank row (a
// stable order built once per encoder stack): a warp per (bank row, head)
// for rows with few pairs, and for rows with many (the global node's, the
// self path's) a block of 32 warps that split the row's pairs in 32
// contiguous parts and add the parts in a fixed order. No atomics: the same
// bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarps = 8;             // nodes per block in B6d / B6s
constexpr int kMaxDh = 128;
constexpr int kMaxDPL = kMaxDh / 32;  // head dims per lane
constexpr int kBuf = 64;              // compacted pairs per warp
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

// (e_ij / scale, dp_ij) of one pair. kDst: the warp's own node is the dst
// i, so `own_a` = q_i and `own_b` = gp_i (f32, shared memory) and the rows
// are x = k_j, y = v_j; otherwise the own node is the src j (own_a = k_j,
// own_b = v_j) and x = q_i, y = gp_i. a_r, b_r: the pair's bank rows.
template <typename T, bool kDst>
__device__ __forceinline__ float2 pair_terms(const float* __restrict__ own_a,
                                             const float* __restrict__ own_b,
                                             const T* __restrict__ xrow,
                                             const T* __restrict__ yrow,
                                             const T* __restrict__ arow,
                                             const T* __restrict__ brow,
                                             float t4, int Dh) {
  float t1 = 0.f, qb = 0.f, ka = 0.f, dp = 0.f;
  for (int d0 = 0; d0 < Dh; d0 += 8) {
    float x[8], y[8], ar[8], br[8];
    load8(xrow + d0, x);
    load8(yrow + d0, y);
    load8(arow + d0, ar);
    load8(brow + d0, br);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float oa = own_a[d0 + c], ob = own_b[d0 + c];
      const float qd = kDst ? oa : x[c];
      const float kd = kDst ? x[c] : oa;
      t1 += qd * kd;
      qb += qd * br[c];
      ka += kd * ar[c];
      dp += ob * y[c];
    }
  }
  return make_float2(t1 + qb + t4 + ka, dp);
}

// One pass: a warp per node n (dst for B6d, src for B6s) of graph b, head
// h, walking the kept pairs of its row of the tile planes 32 at a time.
//   B6d (kDst): tiles = tile_src / tile_rel, writes dq [B, H, N, Dh] and
//        ge [H, E] at each pair's id (row_base + rank in the row);
//   B6s: tiles = tile_dst / tile_rel_src, writes dk and dv.
template <typename T, bool kDst>
__global__ void __launch_bounds__(kWarps * 32)
blk_attn_bwd_pass(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ a_bank,
                  const T* __restrict__ b_bank, const float* __restrict__ t4,
                  const T* __restrict__ gp, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ delta,
                  const int32_t* __restrict__ tiles,
                  const int32_t* __restrict__ rels,
                  const int32_t* __restrict__ row_base, T* __restrict__ out1,
                  T* __restrict__ out2, float* __restrict__ ge_out, int H,
                  int N, int Dh, int P, int Tn, int Smax, int E,
                  float scale) {
  __shared__ __align__(16) float own_all[kWarps][2][kMaxDh];
  __shared__ int buf_o[kWarps][kBuf];
  __shared__ int buf_r[kWarps][kBuf];
  __shared__ int buf_p[kWarps][kBuf];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;  // no block-wide barrier in this kernel
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = bh * N * Dh;
  float* own_a = own_all[warp][0];
  float* own_b = own_all[warp][1];
  int* bo = buf_o[warp];
  int* br = buf_r[warp];
  int* bp = buf_p[warp];
  const size_t own_row = head + static_cast<size_t>(n) * Dh;
  for (int d = lane; d < Dh; d += 32) {
    own_a[d] = to_f32((kDst ? q : k)[own_row + d]);
    own_b[d] = to_f32((kDst ? gp : v)[own_row + d]);
  }
  __syncwarp();
  // the dst node's statistics: the warp's own in B6d
  float m_own = 0.f, l_own = 1.f, d_own = 0.f;
  if (kDst) {
    m_own = m_in[bh * N + n];
    l_own = l_in[bh * N + n] > 0.f ? l_in[bh * N + n] : 1.f;
    d_own = delta[bh * N + n];
  }

  const int t = n / kTile, nl = n - t * kTile;
  const size_t tile_row = static_cast<size_t>(b) * Tn + t;
  const unsigned lt = (1u << lane) - 1u;
  float acc1[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
  float acc2[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
  int cnt = 0;

  auto take = [&](int cnt_now) {
    int o = 0, r = 0;
    float w1 = 0.f, w2 = 0.f;  // B6d: ge'; B6s: ge', p'
    if (lane < cnt_now) {
      o = bo[lane];
      r = br[lane];
      const size_t orow = head + static_cast<size_t>(o) * Dh;
      const size_t row = (static_cast<size_t>(r) * H + h) * Dh;
      const float2 ed = pair_terms<T, kDst>(
          own_a, own_b, (kDst ? k : q) + orow, (kDst ? v : gp) + orow,
          a_bank + row, b_bank + row,
          __ldg(t4 + static_cast<size_t>(r) * H + h), Dh);
      float mi = m_own, li = l_own, di = d_own;
      if (!kDst) {
        mi = m_in[bh * N + o];
        li = l_in[bh * N + o] > 0.f ? l_in[bh * N + o] : 1.f;
        di = delta[bh * N + o];
      }
      const float p = expf(ed.x * scale - mi) / li;
      const float ge = p * (ed.y - di) * scale;
      if (kDst) ge_out[static_cast<size_t>(h) * E + bp[lane]] = ge;
      w1 = round_to<T>(ge);
      w2 = round_to<T>(p);
    }
    for (int c = 0; c < cnt_now; ++c) {
      const float g1 = __shfl_sync(0xffffffffu, w1, c);
      const float g2 = __shfl_sync(0xffffffffu, w2, c);
      const int oc = __shfl_sync(0xffffffffu, o, c);
      const int rc = __shfl_sync(0xffffffffu, r, c);
      const size_t orow = head + static_cast<size_t>(oc) * Dh;
      // dq: k_j + b_r; dk: q_i + a_r (and dv: gp_i)
      const T* xrow = (kDst ? k : q) + orow;
      const T* zrow = (kDst ? b_bank : a_bank) +
                      (static_cast<size_t>(rc) * H + h) * Dh;
#pragma unroll
      for (int tt = 0; tt < kMaxDPL; ++tt) {
        const int d = lane + 32 * tt;
        if (d < Dh) {
          acc1[tt] += g1 * (to_f32(xrow[d]) + to_f32(zrow[d]));
          if (!kDst) acc2[tt] += g2 * to_f32(gp[orow + d]);
        }
      }
    }
  };

  for (int s = 0; s < Smax; ++s) {
    const int other_tile = __ldg(tiles + tile_row * Smax + s);
    if (other_tile < 0) continue;
    const size_t plane_row = (tile_row * Smax + s) * kTile + nl;
    const int32_t* rel_row = rels + plane_row * kTile;
    int rank = kDst ? __ldg(row_base + plane_row) : 0;
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int c = lane + 32 * u;
      const int r = __ldg(rel_row + c);
      const int o = other_tile * kTile + c;
      const bool keep = r >= 0 && r < P && o < N;
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int pos = cnt + __popc(mask & lt);
        bo[pos] = o;
        br[pos] = r;
        bp[pos] = rank + __popc(mask & lt);
      }
      cnt += __popc(mask);
      rank += __popc(mask);
      __syncwarp();
      if (cnt >= 32) {
        take(32);
        __syncwarp();
        cnt -= 32;
        if (lane < cnt) {
          bo[lane] = bo[32 + lane];
          br[lane] = br[32 + lane];
          bp[lane] = bp[32 + lane];
        }
        __syncwarp();
      }
    }
  }
  if (cnt > 0) take(cnt);

#pragma unroll
  for (int tt = 0; tt < kMaxDPL; ++tt) {
    const int d = lane + 32 * tt;
    if (d < Dh) {
      out1[own_row + d] = from_f32<T>(acc1[tt]);
      if (!kDst) out2[own_row + d] = from_f32<T>(acc2[tt]);
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

template <typename T, bool kDst>
int launch_pass(const void* q, const void* k, const void* v,
                const void* a_bank, const void* b_bank, const void* t4,
                const void* gp, const void* m, const void* l,
                const void* delta,
                const void* tiles, const void* rels, const void* row_base,
                void* out1, void* out2, void* ge, int B, int H, int N, int Dh,
                int P, int Tn, int Smax, int E, float scale,
                cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, H, B);
  blk_attn_bwd_pass<T, kDst><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(a_bank),
      static_cast<const T*>(b_bank), static_cast<const float*>(t4),
      static_cast<const T*>(gp),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(rels),
      static_cast<const int32_t*>(row_base), static_cast<T*>(out1),
      static_cast<T*>(out2), static_cast<float*>(ge), H, N, Dh, P, Tn, Smax,
      E, scale);
  return static_cast<int>(cudaGetLastError());
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
// float32; Dh a multiple of 8, at most 128. Each returns the
// CUDA error code of its launch (0 = launched).

// B6d: tile_src [B, Td, Smax], tile_rel [B, Td, Smax, 128, 128] int32;
// row_base [B, Td, Smax, 128] int32, the id of each plane row's first kept
// pair (E kept pairs in all); writes dq [B, H, N, Dh] and ge [H, E] float32.
extern "C" int gtos_blk_attn_bwd_dst(int dtype, const void* q, const void* k,
                                     const void* v, const void* a_bank,
                                     const void* b_bank, const void* t4,
                                     const void* gp, const void* m,
                                     const void* l, const void* delta,
                                     const void* tile_src,
                                     const void* tile_rel,
                                     const void* row_base, void* dq, void* ge,
                                     int B, int H, int N, int Dh, int P,
                                     int Td, int Smax, int E, float scale,
                                     void* stream) {
  if (bad_sizes(B, H, N, Dh, P, Td, Smax) || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pass<float, true>(q, k, v, a_bank, b_bank, t4, gp, m, l,
                                    delta, tile_src, tile_rel, row_base, dq,
                                    nullptr, ge, B, H, N, Dh, P, Td, Smax, E,
                                    scale, s);
  if (dtype == 1)
    return launch_pass<__nv_bfloat16, true>(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_src, tile_rel,
        row_base, dq, nullptr, ge, B, H, N, Dh, P, Td, Smax, E, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B6s: tile_dst [B, Ts, Smax_s], tile_rel_src [B, Ts, Smax_s, 128, 128]
// int32 (blocks transposed: [src-local, dst-local]); writes dk, dv
// [B, H, N, Dh].
extern "C" int gtos_blk_attn_bwd_src(int dtype, const void* q, const void* k,
                                     const void* v, const void* a_bank,
                                     const void* b_bank, const void* t4,
                                     const void* gp, const void* m,
                                     const void* l, const void* delta,
                                     const void* tile_dst,
                                     const void* tile_rel_src, void* dk,
                                     void* dv, int B, int H, int N, int Dh,
                                     int P, int Ts, int Smax, float scale,
                                     void* stream) {
  if (bad_sizes(B, H, N, Dh, P, Ts, Smax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pass<float, false>(q, k, v, a_bank, b_bank, t4, gp, m, l,
                                     delta, tile_dst, tile_rel_src, nullptr,
                                     dk, dv, nullptr, B, H, N, Dh, P, Ts,
                                     Smax, 0, scale, s);
  if (dtype == 1)
    return launch_pass<__nv_bfloat16, false>(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_dst, tile_rel_src,
        nullptr, dk, dv, nullptr, B, H, N, Dh, P, Ts, Smax, 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
