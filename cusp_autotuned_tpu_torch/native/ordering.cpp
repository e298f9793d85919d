// Graph orderings — native host runtime component.
//
// Rebuild of symmetric RCM + pseudo-peripheral vertex finding
// (cusp/graph/symmetric_rcm.h, pseudo_peripheral.h).  BFS-based sequential
// algorithms run on the host; the resulting permutations are static data
// around the SpMV kernels (e.g. the autotuner's rcm_dia move).
//
// C ABI, called from Python via ctypes.

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

int32_t bfs_levels(int32_t n, const int32_t* indptr, const int32_t* col,
                   int32_t src, std::vector<int32_t>& levels) {
    levels.assign(n, -1);
    levels[src] = 0;
    std::queue<int32_t> q;
    q.push(src);
    int32_t far = 0;
    while (!q.empty()) {
        int32_t u = q.front();
        q.pop();
        for (int32_t p = indptr[u]; p < indptr[u + 1]; ++p) {
            int32_t v = col[p];
            if (levels[v] < 0) {
                levels[v] = levels[u] + 1;
                far = std::max(far, levels[v]);
                q.push(v);
            }
        }
    }
    return far;
}

}  // namespace

extern "C" {

int32_t pseudo_peripheral(int32_t n, const int32_t* indptr,
                          const int32_t* col) {
    std::vector<int32_t> degree(n);
    for (int32_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    int32_t x = (int32_t)(std::min_element(degree.begin(), degree.end())
                          - degree.begin());
    std::vector<int32_t> levels;
    int32_t ecc = -1;
    while (true) {
        int32_t far = bfs_levels(n, indptr, col, x, levels);
        if (far <= ecc) return x;
        ecc = far;
        int32_t best = -1;
        for (int32_t v = 0; v < n; ++v)
            if (levels[v] == far && (best < 0 || degree[v] < degree[best]))
                best = v;
        x = best;
    }
}

// Reverse Cuthill-McKee permutation: perm[i] = old index at new position i.
void rcm(int32_t n, const int32_t* indptr, const int32_t* col, int32_t* perm) {
    std::vector<int32_t> degree(n);
    for (int32_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    int32_t start = pseudo_peripheral(n, indptr, col);
    std::vector<int32_t> nbrs;
    while ((int32_t)order.size() < n) {
        if (start < 0 || visited[start]) {
            start = -1;
            for (int32_t v = 0; v < n; ++v)
                if (!visited[v] && (start < 0 || degree[v] < degree[start]))
                    start = v;
        }
        std::queue<int32_t> q;
        visited[start] = 1;
        q.push(start);
        while (!q.empty()) {
            int32_t u = q.front();
            q.pop();
            order.push_back(u);
            nbrs.clear();
            for (int32_t p = indptr[u]; p < indptr[u + 1]; ++p)
                if (!visited[col[p]]) nbrs.push_back(col[p]);
            std::sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
                return degree[a] < degree[b];
            });
            for (int32_t v : nbrs) {
                if (!visited[v]) {
                    visited[v] = 1;
                    q.push(v);
                }
            }
        }
        start = -1;
    }
    for (int32_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

}  // extern "C"
