// meshkit: native mesh-preprocessing kernels for nupgcm.
//
// The device compute path is JAX/XLA; this library covers the host-side
// setup that dominates wall-clock on large meshes (the role played by
// the Gmsh C++ kernel + CuthillMcKee.jl in the reference):
//   * gmsh .msh v4.1 ASCII parsing ($Nodes / $Elements)
//   * unique-edge extraction from simplex connectivity
//   * reverse Cuthill-McKee ordering of a dof graph
//   * balanced contiguous partitioning of cells by dof ranges
//
// Exposed as a plain C API consumed through ctypes
// (nupgcm/mesh/native.py), with NumPy fallbacks when the shared
// library is not built.  Build: `make -C native` (g++ -O3 -shared).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// unique edges
// ---------------------------------------------------------------------
// cells: (nc * nvert) vertex ids; writes unique sorted edges into
// edges_out (capacity 2 * max_edges) and per-cell local-edge ids into
// cell_edges_out (nc * nle).  Returns the number of unique edges, or
// -1 if capacity is insufficient.
int64_t meshkit_unique_edges(const int64_t* cells, int64_t nc, int nvert,
                             int64_t* edges_out, int64_t max_edges,
                             int64_t* cell_edges_out) {
  const int tdim = nvert - 1;
  static const int LE2[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  static const int LE3[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
  const int nle = (tdim == 2) ? 3 : 6;
  const int(*LE)[2] = (tdim == 2) ? LE2 : LE3;

  const int64_t total = nc * nle;
  std::vector<std::pair<uint64_t, int64_t>> keyed(total);
  // find max vertex for key packing
  int64_t nv = 0;
  for (int64_t i = 0; i < nc * nvert; ++i) nv = std::max(nv, cells[i]);
  ++nv;
  for (int64_t c = 0; c < nc; ++c) {
    for (int k = 0; k < nle; ++k) {
      int64_t a = cells[c * nvert + LE[k][0]];
      int64_t b = cells[c * nvert + LE[k][1]];
      if (a > b) std::swap(a, b);
      keyed[c * nle + k] = {(uint64_t)a * (uint64_t)nv + (uint64_t)b,
                            c * nle + k};
    }
  }
  std::vector<std::pair<uint64_t, int64_t>> sorted = keyed;
  std::sort(sorted.begin(), sorted.end());
  int64_t ne = 0;
  uint64_t prev = ~0ULL;
  for (int64_t i = 0; i < total; ++i) {
    if (sorted[i].first != prev) {
      if (ne >= max_edges) return -1;
      prev = sorted[i].first;
      edges_out[2 * ne] = (int64_t)(prev / (uint64_t)nv);
      edges_out[2 * ne + 1] = (int64_t)(prev % (uint64_t)nv);
      ++ne;
    }
    cell_edges_out[sorted[i].second] = ne - 1;
  }
  return ne;
}

// ---------------------------------------------------------------------
// reverse Cuthill-McKee on a CSR graph
// ---------------------------------------------------------------------
// indptr (n+1), indices (nnz): symmetric adjacency.  perm_out (n):
// perm_out[k] = old id of new id k (matching scipy's convention).
void meshkit_rcm(const int64_t* indptr, const int64_t* indices, int64_t n,
                 int64_t* perm_out) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> nbrs;

  // BFS level structure from s over unvisited nodes; returns
  // (eccentricity, min-degree node of the last level)
  std::vector<int64_t> level(n);
  auto bfs_far = [&](int64_t s) -> std::pair<int64_t, int64_t> {
    std::vector<int64_t> q{s};
    std::vector<char> seen(n, 0);
    seen[s] = 1;
    level[s] = 0;
    size_t head = 0;
    int64_t maxlev = 0, last = s;
    while (head < q.size()) {
      int64_t u = q[head++];
      for (int64_t j = indptr[u]; j < indptr[u + 1]; ++j) {
        int64_t v = indices[j];
        if (!seen[v] && !visited[v]) {
          seen[v] = 1;
          level[v] = level[u] + 1;
          q.push_back(v);
        }
      }
    }
    for (int64_t u : q) {
      if (level[u] > maxlev ||
          (level[u] == maxlev && degree[u] < degree[last]))
        maxlev = level[u], last = u;
    }
    return {maxlev, last};
  };

  // iterate components, starting each from a pseudo-peripheral node
  std::vector<int64_t> by_degree(n);
  for (int64_t i = 0; i < n; ++i) by_degree[i] = i;
  std::stable_sort(by_degree.begin(), by_degree.end(),
                   [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });
  size_t scan = 0;
  while (order.size() < (size_t)n) {
    while (scan < (size_t)n && visited[by_degree[scan]]) ++scan;
    int64_t start = by_degree[scan];
    // George-Liu pseudo-peripheral refinement
    auto [ecc, far] = bfs_far(start);
    for (int iter = 0; iter < 8; ++iter) {
      auto [ecc2, far2] = bfs_far(far);
      if (ecc2 <= ecc) break;
      ecc = ecc2;
      far = far2;
    }
    start = far;
    visited[start] = 1;
    size_t head = order.size();
    order.push_back(start);
    while (head < order.size()) {
      int64_t u = order[head++];
      nbrs.clear();
      for (int64_t j = indptr[u]; j < indptr[u + 1]; ++j) {
        int64_t v = indices[j];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (int64_t v : nbrs) order.push_back(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------
// balanced contiguous cell partition by min-dof
// ---------------------------------------------------------------------
// Assign each cell to the shard owning its minimum dof id under an
// even dof split: part_out[c] in [0, nparts).
void meshkit_partition_cells(const int64_t* cell_dofs, int64_t nc, int nloc,
                             int64_t ndof, int nparts, int32_t* part_out) {
  const int64_t per = (ndof + nparts - 1) / nparts;
  for (int64_t c = 0; c < nc; ++c) {
    int64_t m = cell_dofs[c * nloc];
    for (int k = 1; k < nloc; ++k)
      m = std::min(m, cell_dofs[c * nloc + k]);
    part_out[c] = (int32_t)std::min<int64_t>(m / per, nparts - 1);
  }
}

// ---------------------------------------------------------------------
// fast gmsh .msh v4.1 $Nodes/$Elements parsing
// ---------------------------------------------------------------------
struct MshData {
  std::vector<double> coords;        // (n_nodes * 3), dense by index
  std::vector<int64_t> node_ids;     // original gmsh ids
  std::vector<int64_t> elem_conn;    // flattened connectivity
  std::vector<int64_t> elem_meta;    // per block: dim, tag, type, count
  std::vector<int64_t> block_offsets;  // into elem_conn, per block
};

static const char* find_section(const char* p, const char* name) {
  std::string key = std::string("$") + name;
  const char* s = strstr(p, key.c_str());
  if (!s) return nullptr;
  s = strchr(s, '\n');
  return s ? s + 1 : nullptr;
}

void* meshkit_parse_msh(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(sz, '\0');
  if (fread(&buf[0], 1, sz, f) != (size_t)sz) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* out = new MshData();
  char* p = const_cast<char*>(find_section(buf.c_str(), "Nodes"));
  if (!p) {
    delete out;
    return nullptr;
  }
  char* end;
  int64_t nblocks = strtoll(p, &end, 10);
  p = end;
  int64_t nnodes = strtoll(p, &end, 10);
  p = end;
  strtoll(p, &end, 10), p = end;  // minTag
  strtoll(p, &end, 10), p = end;  // maxTag
  out->coords.resize(nnodes * 3);
  out->node_ids.resize(nnodes);
  int64_t at = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    strtoll(p, &end, 10), p = end;  // entityDim
    strtoll(p, &end, 10), p = end;  // entityTag
    strtoll(p, &end, 10), p = end;  // parametric
    int64_t n = strtoll(p, &end, 10);
    p = end;
    for (int64_t i = 0; i < n; ++i) {
      out->node_ids[at + i] = strtoll(p, &end, 10);
      p = end;
    }
    for (int64_t i = 0; i < n; ++i) {
      for (int d = 0; d < 3; ++d) {
        out->coords[(at + i) * 3 + d] = strtod(p, &end);
        p = end;
      }
    }
    at += n;
  }

  p = const_cast<char*>(find_section(buf.c_str(), "Elements"));
  if (!p) {
    delete out;
    return nullptr;
  }
  static const int nodes_per_type[32] = {0, 2, 3, 4, 4, 8, 6, 5, 3, 6, 9, 10,
                                         0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0,
                                         0, 0, 0, 0, 0, 0, 0, 0};
  nblocks = strtoll(p, &end, 10);
  p = end;
  strtoll(p, &end, 10), p = end;  // numElements
  strtoll(p, &end, 10), p = end;
  strtoll(p, &end, 10), p = end;
  for (int64_t b = 0; b < nblocks; ++b) {
    int64_t dim = strtoll(p, &end, 10);
    p = end;
    int64_t tag = strtoll(p, &end, 10);
    p = end;
    int64_t type = strtoll(p, &end, 10);
    p = end;
    int64_t n = strtoll(p, &end, 10);
    p = end;
    int nv = (type < 32) ? nodes_per_type[type] : 0;
    if (nv == 0) {
      delete out;
      return nullptr;
    }
    out->elem_meta.insert(out->elem_meta.end(), {dim, tag, type, n});
    out->block_offsets.push_back((int64_t)out->elem_conn.size());
    for (int64_t i = 0; i < n; ++i) {
      strtoll(p, &end, 10);  // element tag (unused)
      p = end;
      for (int k = 0; k < nv; ++k) {
        out->elem_conn.push_back(strtoll(p, &end, 10));
        p = end;
      }
    }
  }
  return out;
}

int64_t meshkit_msh_n_nodes(void* h) { return ((MshData*)h)->node_ids.size(); }
int64_t meshkit_msh_n_blocks(void* h) {
  return ((MshData*)h)->elem_meta.size() / 4;
}
int64_t meshkit_msh_conn_size(void* h) {
  return ((MshData*)h)->elem_conn.size();
}
void meshkit_msh_copy(void* h, double* coords, int64_t* node_ids,
                      int64_t* elem_meta, int64_t* block_offsets,
                      int64_t* elem_conn) {
  auto* d = (MshData*)h;
  memcpy(coords, d->coords.data(), d->coords.size() * sizeof(double));
  memcpy(node_ids, d->node_ids.data(), d->node_ids.size() * sizeof(int64_t));
  memcpy(elem_meta, d->elem_meta.data(), d->elem_meta.size() * sizeof(int64_t));
  memcpy(block_offsets, d->block_offsets.data(),
         d->block_offsets.size() * sizeof(int64_t));
  memcpy(elem_conn, d->elem_conn.data(), d->elem_conn.size() * sizeof(int64_t));
}
void meshkit_msh_free(void* h) { delete (MshData*)h; }

}  // extern "C"
