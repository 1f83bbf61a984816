// tlfea native host core: graph coloring + incidence structures (the
// port's copy of native/tlfea_native.cpp, loaded by tlfea_torch/native.py).
//
// Host-side preprocessing that the reference implements in C++ on Eigen
// (`lib_utils/cpu_utils.cc`: BuildVertexAdjacency, GreedyVertexColoring,
// BuildNodeIncidence). These are the setup-time hot paths for large meshes
// (100k+ elements): pure-Python set-based coloring is O(minutes) there,
// this implementation is O(seconds). Exposed over a C ABI for ctypes; the
// Python layer falls back to the NumPy implementation when the shared
// library is unavailable.
//
// Build (tlfea_torch/native.py does it at first use, into tlfea_torch/_build/):
//   g++ -O2 -shared -fPIC -o libtlfea_native_<hash>.so native.cpp

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Greedy first-fit vertex coloring of the coefficient-adjacency graph
// (coefficients are adjacent iff they share an element).
//
// conn: n_elem x S element->coefficient connectivity (row-major int32)
// colors_out: n_coef int32
// returns number of colors, or -1 on error.
int32_t tlfea_greedy_color(
    int32_t n_coef, int32_t n_elem, int32_t S,
    const int32_t* conn, int32_t* colors_out) {
  if (n_coef <= 0 || n_elem < 0 || S <= 0) return -1;

  // CSR adjacency via two passes over element cliques, then dedup.
  std::vector<int32_t> degree(n_coef, 0);
  for (int64_t e = 0; e < n_elem; ++e) {
    for (int32_t a = 0; a < S; ++a) {
      int32_t ca = conn[e * S + a];
      if (ca < 0 || ca >= n_coef) return -1;
      degree[ca] += S - 1;
    }
  }
  std::vector<int64_t> offset(n_coef + 1, 0);
  for (int32_t i = 0; i < n_coef; ++i) offset[i + 1] = offset[i] + degree[i];
  std::vector<int32_t> adj(offset[n_coef]);
  std::vector<int64_t> cursor(offset.begin(), offset.end() - 1);
  for (int64_t e = 0; e < n_elem; ++e) {
    const int32_t* row = conn + e * S;
    for (int32_t a = 0; a < S; ++a) {
      for (int32_t b = 0; b < S; ++b) {
        if (a == b) continue;
        adj[cursor[row[a]]++] = row[b];
      }
    }
  }
  // Sort + unique each row in place.
  for (int32_t i = 0; i < n_coef; ++i) {
    auto beg = adj.begin() + offset[i];
    auto end = adj.begin() + offset[i] + degree[i];
    std::sort(beg, end);
    degree[i] = static_cast<int32_t>(std::unique(beg, end) - beg);
  }

  // First-fit greedy in natural order (matches the reference's and the
  // Python fallback's ordering, so colorings agree).
  std::fill(colors_out, colors_out + n_coef, -1);
  std::vector<int32_t> mark;  // color -> last node that used it
  int32_t n_colors = 0;
  for (int32_t v = 0; v < n_coef; ++v) {
    mark.resize(n_colors, -1);
    for (int32_t k = 0; k < degree[v]; ++k) {
      int32_t u = adj[offset[v] + k];
      int32_t cu = colors_out[u];
      if (cu >= 0) mark[cu] = v;
    }
    int32_t c = 0;
    while (c < n_colors && mark[c] == v) ++c;
    if (c == n_colors) { ++n_colors; mark.push_back(-1); }
    colors_out[v] = c;
  }
  return n_colors;
}

// Max incidence count over coefficients (pass 1 for sizing).
int32_t tlfea_max_incidence(
    int32_t n_coef, int32_t n_elem, int32_t S, const int32_t* conn) {
  std::vector<int32_t> count(n_coef, 0);
  for (int64_t e = 0; e < n_elem; ++e)
    for (int32_t a = 0; a < S; ++a) {
      int32_t c = conn[e * S + a];
      if (c < 0 || c >= n_coef) return -1;
      ++count[c];
    }
  return *std::max_element(count.begin(), count.end());
}

// Padded (element, local-index) incidence lists (pass 2).
// inc_out: n_coef x max_inc x 2 int32 (zero-padded); mask_out: n_coef x
// max_inc uint8.
int32_t tlfea_build_incidence(
    int32_t n_coef, int32_t n_elem, int32_t S, const int32_t* conn,
    int32_t max_inc, int32_t* inc_out, uint8_t* mask_out) {
  std::fill(inc_out, inc_out + (int64_t)n_coef * max_inc * 2, 0);
  std::fill(mask_out, mask_out + (int64_t)n_coef * max_inc, 0);
  std::vector<int32_t> count(n_coef, 0);
  for (int64_t e = 0; e < n_elem; ++e) {
    for (int32_t a = 0; a < S; ++a) {
      int32_t c = conn[e * S + a];
      int32_t k = count[c]++;
      if (k >= max_inc) return -1;
      int64_t base = ((int64_t)c * max_inc + k);
      inc_out[base * 2 + 0] = static_cast<int32_t>(e);
      inc_out[base * 2 + 1] = a;
      mask_out[base] = 1;
    }
  }
  return 0;
}

}  // extern "C"
