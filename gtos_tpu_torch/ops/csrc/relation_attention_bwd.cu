// Relation-aware graph attention over the batch-global relation bank,
// backward, for Hopper (sm_90a): two launches, counted as one call.
//
// Replaces: gtos_tpu/ops/pallas/relation_attention_bwd.py `_bwd_kernel`
// (wrapper `fused_relation_attention_bwd`, called by the custom VJP
// `_rel_attn_bwd` in relation_attention.py).
//
// From the score tables t2, t3 [B, H, N, P] (t4 folded into t2, as B3 takes
// them) and the output's cotangent g [B, H, N, Dh], for graph b, head h,
// r = idx[b, i, j]:
//   attn_ij = softmax_j((q_i.k_j + t2[i, r] + t3[j, r]) * scale + mask_j)
//   gv_j    = sum_i attn_ij g_i
//   ge_ij   = attn_ij * (g_i.v_j - sum_j' attn_ij' g_i.v_j') * scale
//   gq_i    = sum_j ge_ij k_j             gk_j = sum_i ge_ij q_i
//   g_t2[b, i, h, p] = sum_{j: idx[b,i,j] = p} ge_ij
//   g_t3[b, j, h, p] = sum_{i: idx[b,i,j] = p} ge_ij
// with attn in f32 (not rounded), every sum in f32, gq/gk/gv in f32 and the
// table gradients in the table type, row-major [B, N, H, P] and dense: every
// entry is written, zero where no pair refers to it. As the TPU kernel's
// one-hot matmuls in the table type do, each ge_ij is rounded to the table
// type before it is summed (relation_attention_bwd.py:145).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32): about
// ten multiply-adds per pair and head dimension, a few hundred MFLOP per
// training batch, against the bytes of q, k, v, g, the referenced table
// entries, idx and the two walk orders read, gq/gk/gv written, and the
// dense g_t2/g_t3 written in full: the bytes bound it, most of them the
// dense table gradients.
//
// Design: the TPU kernel turns the gather's transpose into one-hot matmuls
// on the MXU, because Mosaic has no scatter. Here, on the skeleton of the
// localized B2 (local_relation_attention_bwd.cu): a block per (graph,
// node) and up to 8 heads, a warp a head, 4 groups of 8 lanes a warp, a
// group kGu pairs a round, each lane 16 bytes of a row at a time:
//   1. the row pass (`rel_bwd_rows`), a block per (graph, query row i):
//      the block stages row i's bank rows, its `row_order` and the key mask
//      once for its heads (each head warp reads q_i and g_i in the same
//      round trip); each head warp scores its row (q_i.k_j and g_i.v_j
//      from the chunks of k_j and v_j; t2[i, r] and t3[j, r] by two lanes
//      of the group), keeps the N scores in shared memory for the exact
//      two-pass softmax, forms ge_ij and gq_i = sum_j ge_ij k_j, and writes
//      each pair's (ge, p) in f32 key-major, gep [B, N(j), N(i), H], so that
//      a key's column and a pair's heads are contiguous for the column pass;
//   2. the column pass (`rel_bwd_cols`), a block per (graph, key j): the
//      head warps read column j's (ge, p) contiguously and sum gv_j and
//      gk_j in a fixed order (each group its own rows, the 4 groups added
//      in a fixed butterfly).
// Each pass then writes its node's all-heads row of the dense table
// gradient (g_t2[b, i, :, :] or g_t3[b, j, :, :], H*P contiguous values)
// from the whole block (`write_dense_rows`): the row is staged in shared
// memory in the table type a tile of P entries at a time, zeroed, the run
// sums placed, then stored 16 bytes a thread, so the zeros and the sums
// leave as one stream, each entry written once. The runs of equal bank
// rows come from `row_order` / `col_order` [B, N, N] (a stable argsort of
// each row of idx and of each column, built once per encoder stack), and
// the lane at the head of a run sums its pairs in ascending pair order.
// No atomics anywhere: the same bits on every run. Most of B4's time is
// the dense writes: on the H100 its two launches take about 1.5x the time
// of writing the two tables alone with torch's zero_ (PERF.md, Findings);
// storing the zero chunks while a pass gathers, 4 pairs a group a round
// and 6 blocks an SM were measured slower, 16 KB tiles no faster.

#include <math.h>

#include "block_sparse_common.cuh"

namespace {

using namespace blk;

constexpr int kMaxN = 128;         // node bucket limit (as the TPU kernel)
constexpr int kHeads = 8;          // head warps a block
constexpr int kGl = kPairLanes;    // lanes a pair
constexpr int kGroups = 32 / kGl;
constexpr int kTileBytes = 32768;  // a block's staged table-gradient tile

template <typename T> struct BwdArgs {
  const T* q; const T* k; const T* v; const T* g; const T* t2; const T* t3;
  const int32_t* idx; const uint8_t* mask;
  const int32_t* row_order; const int32_t* col_order;
  float2* gep;     // [B, N(j), N(i), H] (ge, p)
  float* gq; float* gk; float* gv; T* gt2; T* gt3;
  int H, N, Dh, P;
  int tile;        // entries of a head's row staged at once (a multiple of 8)
  float scale;
};

// The sum of each run of equal keys of the sorted keys s_key [N], at the
// run's head s in sums[s]: the values w[s_ord[t]] of the run, each rounded
// to T, added in ascending t. One warp; lanes across the runs' heads, each
// reading 4 of its run's entries at a time.
template <typename T>
__device__ __forceinline__ void run_sums(const int* s_key, const int* s_ord,
                                         const float* w, float* sums, int N,
                                         int lane) {
  for (int s = lane; s < N; s += 32) {
    const int key = s_key[s];
    if (s > 0 && s_key[s - 1] == key) continue;
    float sum = 0.f;
    for (int t = s; t < N; t += 4) {
      int kk[4];
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kk[u] = t + u < N ? s_key[t + u] : -1;
        vv[u] = t + u < N ? w[s_ord[t + u]] : 0.f;
      }
      bool more = true;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        more = more && kk[u] == key;
        if (more) sum += round_to<T>(vv[u]);
      }
      if (!more) break;
    }
    sums[s] = sum;
  }
}

// The rows of the block's heads h0 .. h0 + nh of one node's dense table
// gradient, out [H, P] (this node's), every entry written: the sum of a
// run at its key (sums[hh * kMaxN + s] at each run's head s of the sorted
// keys s_key [N]), zero elsewhere. Staged `tile` entries a head at a time
// in buf [nh][tile] (shared memory), stored 16 bytes a thread where a row
// of P values keeps 16-byte alignment, else a value at a time. Every
// thread of the block calls it.
template <typename T>
__device__ __forceinline__ void write_dense_rows(
    T* __restrict__ out, int h0, int nh, int P, int tile, int N,
    const int* s_key, const float* sums, T* buf) {
  constexpr int per = 16 / static_cast<int>(sizeof(T));
  const bool vec = (static_cast<size_t>(P) * sizeof(T)) % 16 == 0;
  const int units = nh * tile / per;
  for (int p0 = 0; p0 < P; p0 += tile) {
    const int w = min(tile, P - p0);
    for (int e = threadIdx.x; e < units; e += blockDim.x)
      reinterpret_cast<uint4*>(buf)[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int e = threadIdx.x; e < nh * N; e += blockDim.x) {
      const int hh = e / N, s = e - hh * N;
      const int key = s_key[s];
      if ((s == 0 || s_key[s - 1] != key) && key >= p0 && key < p0 + w)
        buf[hh * tile + key - p0] = from_f32<T>(sums[hh * kMaxN + s]);
    }
    __syncthreads();
    if (vec) {
      const int wu = w / per;   // P and tile are multiples of per
      for (int e = threadIdx.x; e < nh * wu; e += blockDim.x) {
        const int hh = e / wu, c = e - hh * wu;
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(h0 + hh) * P +
                                  p0 + c * per) =
            reinterpret_cast<const uint4*>(buf + hh * tile)[c];
      }
    } else {
      for (int e = threadIdx.x; e < nh * w; e += blockDim.x) {
        const int hh = e / w, c = e - hh * w;
        out[static_cast<size_t>(h0 + hh) * P + p0 + c] = buf[hh * tile + c];
      }
    }
    __syncthreads();   // the tile is read before the next one is zeroed
  }
}

// 1. Query row blockIdx.x of graph blockIdx.z; warp w the head
// blockIdx.y * 8 + w. A lane holds kCpl chunks of a row (Dh up to 64 kCpl),
// a group kGu pairs a round.
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
rel_bwd_rows(const BwdArgs<T> a) {
  __shared__ int s_r[kMaxN];               // row i's bank rows
  __shared__ int s_ord[kMaxN];             // row_order[b, i]
  __shared__ int s_key[kMaxN];             // s_r[s_ord[s]]
  __shared__ float s_mask[kMaxN];          // 0 or -1e9 per key
  __shared__ float s_p[kHeads][kMaxN];     // scores, then attn
  __shared__ float s_ge[kHeads][kMaxN];    // g_i.v_j, then ge_ij
  __shared__ float s_sum[kHeads][kMaxN];   // run sums of g_t2's row
  extern __shared__ __align__(16) unsigned char s_tile[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int i = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, P = a.P, C = Dh / 8;
  const int h0 = blockIdx.y * kHeads, h = h0 + warp;
  const int nh = min(kHeads, H - h0);
  const size_t row = static_cast<size_t>(b) * N + i;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = bh * N * Dh;
  const size_t own = head + static_cast<size_t>(i) * Dh;
  // q_i and g_i, read with the row's bank rows and order
  Chunk<T> qc[kCpl], gc[kCpl];
  if (warp < nh) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const int c = li + kGl * cc;
      if (c < C) {
        load_chunk(a.q + own + c * 8, qc[cc]);
        load_chunk(a.g + own + c * 8, gc[cc]);
      }
    }
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    s_r[j] = __ldg(a.idx + row * N + j);
    s_ord[j] = __ldg(a.row_order + row * N + j);
    s_mask[j] = a.mask[static_cast<size_t>(b) * N + j] ? 0.f : -1e9f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) s_key[j] = s_r[s_ord[j]];
  __syncthreads();

  if (warp < nh) {
    const T* t2_row = a.t2 + (bh * N + i) * P;
    const T* t3_head = a.t3 + bh * N * P;
    float* e = s_p[warp];
    float* ga = s_ge[warp];
    // scores and g_i.v_j, kGroups * kGu keys a round; lane 0 of a group
    // adds t2[i, r] to its part, lane 1 t3[j, r]
    for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
      Chunk<T> kc[kGu][kCpl], vc[kGu][kCpl];
      float rel[kGu];
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        rel[uu] = 0.f;
        if (j < N) {
          const int r = s_r[j];
          if (li == 0) rel[uu] = to_f32(t2_row[r]);
          if (li == 1)
            rel[uu] = to_f32(t3_head[static_cast<size_t>(j) * P + r]);
          const size_t krow = head + static_cast<size_t>(j) * Dh;
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C) {
              load_chunk(a.k + krow + c * 8, kc[uu][cc]);
              load_chunk(a.v + krow + c * 8, vc[uu][cc]);
            }
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        float s = rel[uu], d = 0.f;
        if (j < N) {
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float q8[8], k8[8], g8[8], v8[8];
              unpack(qc[cc], q8);
              unpack(kc[uu][cc], k8);
              unpack(gc[cc], g8);
              unpack(vc[uu][cc], v8);
#pragma unroll
              for (int x = 0; x < 8; ++x) {
                s += q8[x] * k8[x];
                d += g8[x] * v8[x];
              }
            }
          }
        }
        s = group_sum(s);
        d = group_sum(d);
        if (j < N && li == 0) {
          e[j] = s * a.scale + s_mask[j];
          ga[j] = d;
        }
      }
    }
    __syncwarp();
    // the exact two-pass softmax (attn in f32), then ge
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, e[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(e[j] - m);
      e[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    float dot = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = e[j] / sum;
      e[j] = p;
      dot += ga[j] * p;
    }
    dot = warp_sum(dot);
    for (int j = lane; j < N; j += 32) ga[j] = e[j] * (ga[j] - dot) * a.scale;
    __syncwarp();

    // gq_i = sum_j ge_ij k_j
    float acc[kCpl * 8];
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) acc[x] = 0.f;
    for (int j0 = 0; j0 < N; j0 += kGroups * kGu) {
      Chunk<T> kc[kGu][kCpl];
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        if (j < N) {
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C)
              load_chunk(a.k + head + static_cast<size_t>(j) * Dh + c * 8,
                         kc[uu][cc]);
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int j = j0 + grp + kGroups * uu;
        if (j < N) {
          const float w = ga[j];
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float k8[8];
              unpack(kc[uu][cc], k8);
#pragma unroll
              for (int x = 0; x < 8; ++x) acc[cc * 8 + x] += w * k8[x];
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
        if (c < C) store8(a.gq + own + c * 8, acc + cc * 8);
      }
    }
    run_sums<T>(s_key, s_ord, ga, s_sum[warp], N, lane);
  }
  __syncthreads();
  // (ge, p) of the block's heads at [b, j, i, h], a pair's heads contiguous
  for (int t = threadIdx.x; t < N * nh; t += blockDim.x) {
    const int j = t / nh, hh = t - j * nh;
    a.gep[((static_cast<size_t>(b) * N + j) * N + i) * H + h0 + hh] =
        make_float2(s_ge[hh][j], s_p[hh][j]);
  }
  write_dense_rows<T>(a.gt2 + row * H * P, h0, nh, P, a.tile, N, s_key,
                      &s_sum[0][0], reinterpret_cast<T*>(s_tile));
}

// 2. Key column blockIdx.x of graph blockIdx.z; warp w the head
// blockIdx.y * 8 + w.
template <typename T, int kCpl, int kGu>
__global__ void __launch_bounds__(kHeads * 32)
rel_bwd_cols(const BwdArgs<T> a) {
  __shared__ int s_r[kMaxN];               // column j's bank rows
  __shared__ int s_ord[kMaxN];             // col_order[b, j]
  __shared__ int s_key[kMaxN];             // s_r[s_ord[s]]
  __shared__ float s_ge[kHeads][kMaxN];    // ge_ij of column j
  __shared__ float s_p[kHeads][kMaxN];     // attn_ij of column j
  __shared__ float s_sum[kHeads][kMaxN];   // run sums of g_t3's row
  extern __shared__ __align__(16) unsigned char s_tile[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGl, li = lane % kGl;
  const int j = blockIdx.x, b = blockIdx.z;
  const int H = a.H, N = a.N, Dh = a.Dh, P = a.P, C = Dh / 8;
  const int h0 = blockIdx.y * kHeads, h = h0 + warp;
  const int nh = min(kHeads, H - h0);
  const size_t col = static_cast<size_t>(b) * N + j;
  for (int s = threadIdx.x; s < N; s += blockDim.x) {
    s_r[s] = __ldg(a.idx + (static_cast<size_t>(b) * N + s) * N + j);
    s_ord[s] = __ldg(a.col_order + col * N + s);
  }
  for (int t = threadIdx.x; t < N * nh; t += blockDim.x) {
    const int i = t / nh, hh = t - i * nh;
    const float2 e = a.gep[(col * N + i) * H + h0 + hh];
    s_ge[hh][i] = e.x;
    s_p[hh][i] = e.y;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < N; s += blockDim.x) s_key[s] = s_r[s_ord[s]];
  __syncthreads();

  if (warp < nh) {
    const size_t head = (static_cast<size_t>(b) * H + h) * N * Dh;
    const float* ge = s_ge[warp];
    const float* p = s_p[warp];
    // gk_j = sum_i ge_ij q_i, gv_j = sum_i attn_ij g_i
    float ak[kCpl * 8], av[kCpl * 8];
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) ak[x] = av[x] = 0.f;
    for (int i0 = 0; i0 < N; i0 += kGroups * kGu) {
      Chunk<T> qc[kGu][kCpl], gc[kGu][kCpl];
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int i = i0 + grp + kGroups * uu;
        if (i < N) {
          const size_t irow = head + static_cast<size_t>(i) * Dh;
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            const int c = li + kGl * cc;
            if (c < C) {
              load_chunk(a.q + irow + c * 8, qc[uu][cc]);
              load_chunk(a.g + irow + c * 8, gc[uu][cc]);
            }
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < kGu; ++uu) {
        const int i = i0 + grp + kGroups * uu;
        if (i < N) {
          const float w = ge[i], pw = p[i];
#pragma unroll
          for (int cc = 0; cc < kCpl; ++cc) {
            if (li + kGl * cc < C) {
              float q8[8], g8[8];
              unpack(qc[uu][cc], q8);
              unpack(gc[uu][cc], g8);
#pragma unroll
              for (int x = 0; x < 8; ++x) {
                ak[cc * 8 + x] += w * q8[x];
                av[cc * 8 + x] += pw * g8[x];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int x = 0; x < kCpl * 8; ++x) {
      ak[x] = groups_sum(ak[x]);
      av[x] = groups_sum(av[x]);
    }
    if (grp == 0) {
      const size_t own = head + static_cast<size_t>(j) * Dh;
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = li + kGl * cc;
        if (c < C) {
          store8(a.gk + own + c * 8, ak + cc * 8);
          store8(a.gv + own + c * 8, av + cc * 8);
        }
      }
    }
    run_sums<T>(s_key, s_ord, ge, s_sum[warp], N, lane);
  }
  __syncthreads();
  write_dense_rows<T>(a.gt3 + col * H * P, h0, nh, P, a.tile, N, s_key,
                      &s_sum[0][0], reinterpret_cast<T*>(s_tile));
}

template <typename T, int kCpl, int kGu>
int launch_one(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  const int hb = a.H < kHeads ? a.H : kHeads;   // heads a block
  const dim3 grid(a.N, (a.H + kHeads - 1) / kHeads, B);
  const size_t smem = static_cast<size_t>(hb) * a.tile * sizeof(T);
  rel_bwd_rows<T, kCpl, kGu><<<grid, 32 * hb, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rel_bwd_cols<T, kCpl, kGu><<<grid, 32 * hb, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, g, the tables and the table
// gradients). All tensors contiguous on one device, 16-byte aligned: q, k,
// v, g [B, H, N, Dh]; t2, t3 [B, H, N, P]; idx [B, N, N] int32 bank rows in
// [0, P); mask [B, N] bytes; row_order [B, N, N] int32 (each row of idx
// argsorted, stable); col_order [B, N, N] int32 (each column of idx, i.e.
// each row of idx^T, argsorted, stable); the workspace gep [B, N, N, H]
// float32x2; outputs gq, gk, gv [B, H, N, Dh] float32 and gt2, gt3 [B, N,
// H, P]. Dh a multiple of 8, at most 128; N at most 128. Returns the CUDA
// error code of the launches (0 = launched).
extern "C" int gtos_rel_attn_bwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* g, const void* t2,
                                 const void* t3, const void* idx,
                                 const void* mask, const void* row_order,
                                 const void* col_order, void* gep, void* gq,
                                 void* gk, void* gv, void* gt2, void* gt3,
                                 int B, int H, int N, int Dh, int P,
                                 float scale, void* stream) {
  if (N < 1 || N > kMaxN || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 || B < 1 ||
      H < 1 || P < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(g) || !aligned16(gep) || !aligned16(gq) || !aligned16(gk) ||
      !aligned16(gv) || !aligned16(gt2) || !aligned16(gt3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const int hb = H < kHeads ? H : kHeads;
    const int cap = kTileBytes / static_cast<int>(hb * sizeof(T)) / 8 * 8;
    const int whole = (P + 7) / 8 * 8;
    const int tile = whole < cap ? whole : cap;
    const BwdArgs<T> a{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const T*>(t2), static_cast<const T*>(t3),
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(row_order),
        static_cast<const int32_t*>(col_order), static_cast<float2*>(gep),
        static_cast<float*>(gq), static_cast<float*>(gk),
        static_cast<float*>(gv), static_cast<T*>(gt2), static_cast<T*>(gt3),
        H, N, Dh, P, tile, scale};
    return Dh > 64 ? launch_one<T, 2, 1>(a, B, s)
                   : launch_one<T, 1, 2>(a, B, s);
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}
