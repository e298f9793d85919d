// Greedy (Vanek) aggregation — native host runtime component.
//
// Rebuild of the standard three-pass aggregation used by SA-AMG setup
// (cusp/precond/aggregation/system/detail/generic/standard_aggregate.h):
// pass 1 seeds aggregates from vertices with fully-unaggregated
// neighborhoods, pass 2 attaches stragglers to adjacent aggregates,
// pass 3 makes singletons from the rest.  Sequential host algorithm,
// bound to Python via ctypes like the other native components.

#include <cstdint>
#include <vector>

extern "C" {

// agg out: aggregate id per vertex; roots out: root vertex per aggregate.
// Returns the number of aggregates.
int32_t standard_aggregate(int32_t n, const int32_t* indptr,
                           const int32_t* col, int32_t* agg,
                           int32_t* roots) {
    for (int32_t i = 0; i < n; ++i) agg[i] = -1;
    int32_t n_agg = 0;

    // pass 1: seed where the whole neighborhood is unaggregated
    for (int32_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        bool clean = true;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = col[p];
            if (j != i && agg[j] != -1) {
                clean = false;
                break;
            }
        }
        if (!clean) continue;
        agg[i] = n_agg;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = col[p];
            if (j != i) agg[j] = n_agg;
        }
        roots[n_agg++] = i;
    }

    // pass 2: attach stragglers to an adjacent aggregate (based on the
    // pass-1 state, like the reference)
    std::vector<int32_t> attach(agg, agg + n);
    for (int32_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = col[p];
            if (agg[j] != -1) {
                attach[i] = agg[j];
                break;
            }
        }
    }
    for (int32_t i = 0; i < n; ++i) agg[i] = attach[i];

    // pass 3: leftovers become new aggregates with their unaggregated
    // neighbors
    for (int32_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        agg[i] = n_agg;
        roots[n_agg] = i;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = col[p];
            if (agg[j] == -1) agg[j] = n_agg;
        }
        ++n_agg;
    }
    return n_agg;
}

}  // extern "C"
