// Native byte-pair-encoding merge core.
//
// The host-side hot loop of the img2txt search is the per-generation BPE
// round trip (GPT-2 decode -> CLIP re-encode, reference models.py:32-42 +
// generator.py:53-56). The merge loop is the O(n^2) part; this core runs it
// over integer symbol ids with a hash table from (left, right) pairs to
// (rank, merged_id), shared by both tokenizers (their tables differ, the
// algorithm does not). Built with `g++ -O2 -shared -fPIC` at first use and
// bound with ctypes (tokenizers/native.py); the pure-Python merge loop
// stays the fallback and the behavioural reference.

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

using std::size_t;

namespace {

struct Merger {
    // key: (left << 32) | right  ->  (rank, merged_id)
    std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> table;
};

inline uint64_t pack(int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

void* bpe_create(const int32_t* lefts, const int32_t* rights,
                 const int32_t* merged_ids, int32_t n_merges) {
    auto* m = new Merger();
    m->table.reserve(static_cast<size_t>(n_merges) * 2);
    for (int32_t r = 0; r < n_merges; ++r) {
        m->table.emplace(pack(lefts[r], rights[r]),
                         std::make_pair(r, merged_ids[r]));
    }
    return m;
}

void bpe_free(void* handle) { delete static_cast<Merger*>(handle); }

// Apply the greedy lowest-rank-first merge loop to `n` symbol ids in `syms`.
// Writes the merged sequence to `out` (capacity `cap`) and returns its
// length, or -1 if `out` is too small.
int32_t bpe_apply(const void* handle, const int32_t* syms, int32_t n,
                  int32_t* out, int32_t cap) {
    const auto& table = static_cast<const Merger*>(handle)->table;
    std::vector<int32_t> word(syms, syms + n);
    while (word.size() >= 2) {
        int32_t best_rank = INT32_MAX;
        size_t best_pos = 0;
        int32_t best_id = -1;
        for (size_t i = 0; i + 1 < word.size(); ++i) {
            auto it = table.find(pack(word[i], word[i + 1]));
            if (it != table.end() && it->second.first < best_rank) {
                best_rank = it->second.first;
                best_pos = i;
                best_id = it->second.second;
            }
        }
        if (best_id < 0) break;
        // merge ALL occurrences of this exact pair left-to-right (matches the
        // reference loop, gpt2/encoder.py:60-82)
        std::vector<int32_t> next;
        next.reserve(word.size());
        const int32_t a = word[best_pos], b = word[best_pos + 1];
        for (size_t i = 0; i < word.size();) {
            if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
                next.push_back(best_id);
                i += 2;
            } else {
                next.push_back(word[i]);
                i += 1;
            }
        }
        word.swap(next);
    }
    if (static_cast<int32_t>(word.size()) > cap) return -1;
    for (size_t i = 0; i < word.size(); ++i) out[i] = word[i];
    return static_cast<int32_t>(word.size());
}

}  // extern "C"
