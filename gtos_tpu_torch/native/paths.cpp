// Native all-pairs shortest-path relation extraction.
//
// C++ counterpart of gtos_tpu_torch/graph/paths.py `relation_paths` (the
// preprocessing hot spot: O(n*(n+e)) BFS per graph plus O(n^2) path
// reconstruction, dominated by interpreter overhead in the pure Python
// version). Semantics are bit-identical: reverse arcs appended after the
// forward arc of the same edge (same BFS tie-breaking), labels of a
// shortest path from src, prefix-truncated at max_len.
//
// The function also deduplicates paths per graph and returns (unique
// paths, per-pair index), so the Python layer materializes O(unique)
// tuples instead of O(n^2). The unique-path order (first appearance,
// row-major over the off-diagonal pairs) is the order
// `pack_relation_paths` reproduces in Python.
//
// Exposed through a plain C interface for ctypes
// (gtos_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// Returns the number of unique paths written (>= 1; index 0 is the empty
// path used for self/unreachable pairs), or -1 on cap overflow.
//
//   n, m            : node / edge counts
//   src, dst, lab   : edge triples; lab in [0, num_labels)
//   num_labels      : forward label count (reverse arc label = lab + num_labels)
//   max_len         : truncation cap (kept prefix)
//   out_pair_idx    : [n*n] row-major (src-major) -> unique path index
//   out_paths       : [cap_paths * max_len] label ids
//   out_len         : [cap_paths]
int32_t gtos_relation_paths(
    int32_t n, int32_t m,
    const int32_t* src, const int32_t* dst, const int32_t* lab,
    int32_t num_labels, int32_t max_len,
    int32_t* out_pair_idx, int32_t* out_paths, int32_t* out_len,
    int32_t cap_paths) {
  if (cap_paths < 1 || n < 0 || m < 0) return -1;

  // adjacency with direction-marked reverse arcs, declaration order
  std::vector<std::vector<std::pair<int32_t, int32_t>>> adj(n);
  for (int32_t e = 0; e < m; ++e) {
    adj[src[e]].push_back({dst[e], lab[e]});
    adj[dst[e]].push_back({src[e], lab[e] + num_labels});
  }

  std::unordered_map<std::string, int32_t> dedup;
  dedup.reserve(4 * n);
  out_len[0] = 0;  // path 0: empty (self / unreachable)
  dedup.emplace(std::string(), 0);
  int32_t n_paths = 1;

  std::vector<int32_t> parent(n), plabel(n), queue(n);
  std::vector<char> seen(n);
  std::vector<int32_t> labs;
  labs.reserve(64);

  for (int32_t s = 0; s < n; ++s) {
    std::fill(seen.begin(), seen.end(), 0);
    int32_t head = 0, tail = 0;
    queue[tail++] = s;
    seen[s] = 1;
    while (head < tail) {
      int32_t u = queue[head++];
      for (const auto& vl : adj[u]) {
        if (!seen[vl.first]) {
          seen[vl.first] = 1;
          parent[vl.first] = u;
          plabel[vl.first] = vl.second;
          queue[tail++] = vl.first;
        }
      }
    }
    for (int32_t d = 0; d < n; ++d) {
      if (d == s || !seen[d]) {
        out_pair_idx[(int64_t)s * n + d] = 0;
        continue;
      }
      labs.clear();
      for (int32_t v = d; v != s; v = parent[v]) labs.push_back(plabel[v]);
      int32_t len = (int32_t)labs.size() > max_len
                        ? max_len : (int32_t)labs.size();
      std::string key;
      key.reserve((size_t)len * 4);
      for (int32_t i = 0; i < len; ++i) {
        int32_t L = labs[labs.size() - 1 - i];  // reversed = src->dst order
        key.append(reinterpret_cast<const char*>(&L), 4);
      }
      int32_t idx;
      auto it = dedup.find(key);
      if (it == dedup.end()) {
        if (n_paths >= cap_paths) return -1;
        idx = n_paths++;
        dedup.emplace(std::move(key), idx);
        out_len[idx] = len;
        for (int32_t i = 0; i < len; ++i)
          out_paths[(int64_t)idx * max_len + i] = labs[labs.size() - 1 - i];
      } else {
        idx = it->second;
      }
      out_pair_idx[(int64_t)s * n + d] = idx;
    }
  }
  return n_paths;
}

}  // extern "C"
