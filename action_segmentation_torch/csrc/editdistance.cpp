// Levenshtein distance over int64 token sequences, with a C interface
// for ctypes (action_segmentation_torch/evaluation/editdistance.py).
//
// Unit-cost edit distance, the reference's `editdistance.eval`, over
// the segment label runs of the accuracy metrics. Two-row DP over the
// full table: O(n * m) time, O(min(n, m)) space.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" int64_t edit_distance(const int64_t* a, int64_t na, const int64_t* b, int64_t nb) {
    if (na == 0) return nb;
    if (nb == 0) return na;
    if (na < nb) {
        std::swap(a, b);
        std::swap(na, nb);
    }
    std::vector<int64_t> prev(nb + 1), cur(nb + 1);
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        cur[0] = i;
        const int64_t ai = a[i - 1];
        for (int64_t j = 1; j <= nb; ++j) {
            const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            cur[j] = std::min(sub, std::min(prev[j], cur[j - 1]) + 1);
        }
        std::swap(prev, cur);
    }
    return prev[nb];
}
