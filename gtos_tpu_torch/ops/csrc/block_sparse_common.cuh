// What the block-sparse kernels (block_sparse_attention_fwd.cu and
// block_sparse_attention_bwd.cu), the localized ones
// (local_relation_attention_fwd.cu and local_relation_attention_bwd.cu) and
// the global-bank ones (relation_attention_fwd.cu and
// relation_attention_bwd.cu) share: element conversions, sums across lanes,
// the 8-value row chunks a lane reads 16 bytes (bf16) or 32 bytes (f32) at
// a time, and the walk of an own node's tile planes that a block does once
// for all its head warps. ops/build.py
// hashes this header with each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blk {

constexpr int kTile = 128;
constexpr int kMaxDh = 128;

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

// Sums and maxima across lanes, the same in every lane they cover: a
// warp's 32; a pair's group of kPairLanes; and, lane for lane, the warp's
// 32 / kPairLanes groups, added in a fixed butterfly (the gather kernels'
// 8 lanes a pair, 4 pairs a warp a round).
constexpr int kPairLanes = 8;

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

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kPairLanes; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float groups_sum(float x) {
#pragma unroll
  for (int o = kPairLanes; o < 32; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// 8 floats rounded to T and stored at once (p 16-byte aligned)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int c = 0; c < 4; ++c) h[c] = __floats2bfloat162_rn(x[2 * c], x[2 * c + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// The row chunks of a head dimension that need not be a multiple of 8 (the
// localized kernels): chunk c holds values [8c, 8c + min(8, n)) of the row,
// n = Dh - 8c. With `vec` (Dh a multiple of 8, every row 16-byte aligned)
// one load_chunk / store8; else a value at a time, the missing values read
// as 0 and not written.
template <typename T>
__device__ __forceinline__ void load_chunk_n(const T* p, int n, bool vec,
                                             Chunk<T>& c) {
  if (vec) {
    load_chunk(p, c);
    return;
  }
  T* e = reinterpret_cast<T*>(&c);
#pragma unroll
  for (int x = 0; x < 8; ++x) e[x] = x < n ? p[x] : from_f32<T>(0.f);
}
template <typename T>
__device__ __forceinline__ void store_n(T* p, const float* x, int n,
                                        bool vec) {
  if (vec) {
    store8(p, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) p[e] = from_f32<T>(x[e]);
}

// One round of the plane walk of own node `nl` (its row in its tile) of
// tile row `tile_row`: warp w of the block reads slot s0 + w's tile id,
// the node's plane row of 128 bank rows and, with row_base, the id of the
// row's first kept pair, all in one round trip; it compacts the row's kept
// pairs by ballot, and after a barrier the round's pairs stand in the
// lists in slot order, each slot's in column order: list_o the partner
// node (tile id * 128 + column), list_r the bank row and, with row_base,
// list_id the pair's id (first id + rank in the row). A pair is kept when
// its slot holds a tile, its bank row is in [0, P) and its partner is
// below N. Every thread of the block calls it; returns the number of
// pairs in the lists. The caller puts a barrier between walking the lists
// and the next round, which rewrites them.
__device__ __forceinline__ int plane_round(
    const int32_t* __restrict__ tiles, const int32_t* __restrict__ rels,
    const int32_t* __restrict__ row_base, size_t tile_row, int nl, int s0,
    int Smax, int P, int N, int* counts, int* list_o, int* list_r,
    int* list_id) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = s0 + warp;
  int other = -1, rank0 = 0;
  int4 rv = make_int4(-1, -1, -1, -1);
  if (s < Smax) {
    const size_t plane_row = (tile_row * Smax + s) * kTile + nl;
    other = __ldg(tiles + tile_row * Smax + s);
    rv = __ldg(reinterpret_cast<const int4*>(rels + plane_row * kTile) +
               lane);
    if (row_base != nullptr) rank0 = __ldg(row_base + plane_row);
  }
  const int rs[4] = {rv.x, rv.y, rv.z, rv.w};
  const unsigned lt = (1u << lane) - 1u;
  unsigned bits = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool keep = other >= 0 && rs[u] >= 0 && rs[u] < P &&
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
      if (list_id != nullptr) list_id[off + pos] = rank0 + pos;
      ++pos;
    }
  }
  __syncthreads();
  return all;
}

}  // namespace blk
