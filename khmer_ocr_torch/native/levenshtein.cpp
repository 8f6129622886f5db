// Batch Levenshtein distance over UTF-32 strings.
//
// Native (C++) eval-path kernel: CER evaluation over large corpora
// (reference: the pure-Python DP in CNN-Transformer.ipynb [cell 19]; the
// framework's numpy row-DP in metrics.py is ~50x faster than that, and this
// kernel removes the remaining Python/numpy overhead for production-scale
// evals). Exposed via ctypes; built on demand by native/build.py.
//
// API (C):
//   levenshtein_batch(refs, ref_offsets, hyps, hyp_offsets, n, out)
//     refs/hyps: concatenated uint32 code points
//     *_offsets: n+1 prefix offsets
//     out: n int64 distances
// Threaded with a simple static partition over items.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

int64_t lev_one(const uint32_t* a, int64_t la, const uint32_t* b, int64_t lb) {
    if (la == 0) return lb;
    if (lb == 0) return la;
    if (lb > la) {  // keep the DP row as the shorter string
        std::swap(a, b);
        std::swap(la, lb);
    }
    std::vector<int64_t> row(lb + 1);
    for (int64_t j = 0; j <= lb; ++j) row[j] = j;
    for (int64_t i = 1; i <= la; ++i) {
        int64_t diag = row[0];
        row[0] = i;
        const uint32_t ca = a[i - 1];
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t sub = diag + (b[j - 1] != ca);
            diag = row[j];
            row[j] = std::min({sub, diag + 1, row[j - 1] + 1});
        }
    }
    return row[lb];
}

}  // namespace

extern "C" void levenshtein_batch(
    const uint32_t* refs, const int64_t* ref_offsets,
    const uint32_t* hyps, const int64_t* hyp_offsets,
    int64_t n, int64_t* out, int64_t num_threads) {
    if (num_threads <= 0) {
        num_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
        if (num_threads <= 0) num_threads = 1;
    }
    num_threads = std::min<int64_t>(num_threads, std::max<int64_t>(n, 1));
    auto work = [&](int64_t t) {
        for (int64_t i = t; i < n; i += num_threads) {
            out[i] = lev_one(
                refs + ref_offsets[i], ref_offsets[i + 1] - ref_offsets[i],
                hyps + hyp_offsets[i], hyp_offsets[i + 1] - hyp_offsets[i]);
        }
    };
    if (num_threads == 1) {
        work(0);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int64_t t = 0; t < num_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}
