// seqminer — sequence-pattern mining + pair matching on the host.
//
// The PyTorch port's own copy of dr4sr_tpu/cpp/seqminer.cpp: the same C API
// and the same results. It replaces the reference's Seq2Pat miner
// (1.Build_pretraining_dataset.py:24-28) and its O(N·patterns) Python
// `is_sublist` scan (:70-89). The work is irregular and hash-heavy, so it
// runs on the CPU in C++/OpenMP behind a C ABI loaded with ctypes
// (dr4sr_tpu_torch/regen/miner.py builds it into dr4sr_tpu_torch/_build/).
//
// Semantics:
//   mine_patterns: frequent ordered subsequences (length >= 2) where every
//     occurrence fits inside a window of `max_span` consecutive positions;
//     support = number of distinct sequences containing such an occurrence;
//     keep support >= min_frequency. (Seq2Pat's rolling-window model.)
//     Enumeration: for each start position i, all subsequences of
//     seq[i:i+max_span] that include position i — each subsequence with span
//     <= max_span is counted exactly once per (sequence, first-position),
//     deduped per sequence. Work is O(N · L · 2^(max_span-1)).
//   match_pairs: for each sequence, up to `max_matches` mined patterns that
//     are (unconstrained) subsequences of it — reference semantics of
//     is_sublist — found via an inverted index on the pattern's first two
//     items, randomized per sequence with a seeded LCG like the reference's
//     shuffle(patterns).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC seqminer.cpp -o libseqminer.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using Pattern = std::vector<int32_t>;

struct PatternHash {
  size_t operator()(const Pattern& p) const {
    size_t h = 1469598103934665603ull;
    for (int32_t v : p) {
      h ^= static_cast<size_t>(v) + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return h;
  }
};

using CountMap = std::unordered_map<Pattern, int64_t, PatternHash>;
using PatternSet = std::unordered_set<Pattern, PatternHash>;

// Enumerate all subsequences of window starting at its first element,
// collecting those of length >= 2 into `out` (deduped by the caller).
void enumerate_from_start(const int32_t* seq, int64_t len, int64_t start,
                          int64_t max_span, PatternSet& out) {
  int64_t w = std::min(max_span, len - start);
  if (w < 2) return;
  // bitmask over positions start+1 .. start+w-1 (position `start` always in)
  int64_t tail = w - 1;
  for (uint32_t mask = 1; mask < (1u << tail); ++mask) {
    Pattern p;
    p.reserve(w);
    p.push_back(seq[start]);
    for (int64_t j = 0; j < tail; ++j) {
      if (mask & (1u << j)) p.push_back(seq[start + 1 + j]);
    }
    out.insert(std::move(p));
  }
}

struct MineResult {
  std::vector<Pattern> patterns;
  std::vector<int64_t> freqs;
};

MineResult* g_last_mine = nullptr;

struct MatchResult {
  // flattened: for each sequence, the indices of matched patterns
  std::vector<int64_t> flat;
  std::vector<int64_t> offsets;  // len = num_seqs + 1
};

MatchResult* g_last_match = nullptr;

}  // namespace

extern "C" {

// Mine patterns from ragged sequences (flat + offsets, CSR-style).
// Returns the number of frequent patterns; results cached for the getters.
int64_t mine_patterns(const int32_t* flat, const int64_t* offsets,
                      int64_t num_seqs, int64_t max_span, int64_t min_frequency,
                      int64_t n_jobs) {
#ifdef _OPENMP
  int threads = n_jobs > 0 ? static_cast<int>(n_jobs) : omp_get_max_threads();
#else
  int threads = 1;
#endif
  std::vector<CountMap> local(threads);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads)
#endif
  for (int64_t s = 0; s < num_seqs; ++s) {
#ifdef _OPENMP
    CountMap& counts = local[omp_get_thread_num()];
#else
    CountMap& counts = local[0];
#endif
    const int32_t* seq = flat + offsets[s];
    int64_t len = offsets[s + 1] - offsets[s];
    PatternSet seen;  // per-sequence dedupe -> support counts sequences
    for (int64_t i = 0; i + 1 < len; ++i) {
      enumerate_from_start(seq, len, i, max_span, seen);
    }
    for (const auto& p : seen) counts[p] += 1;
  }

  // merge thread-local counts
  CountMap merged;
  for (auto& m : local) {
    if (merged.empty()) {
      merged = std::move(m);
      continue;
    }
    for (auto& kv : m) merged[kv.first] += kv.second;
    m.clear();
  }

  auto* result = new MineResult();
  for (auto& kv : merged) {
    if (kv.second >= min_frequency) {
      result->patterns.push_back(kv.first);
      result->freqs.push_back(kv.second);
    }
  }
  // deterministic order: by frequency desc, then lexicographic
  std::vector<size_t> order(result->patterns.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    if (result->freqs[a] != result->freqs[b])
      return result->freqs[a] > result->freqs[b];
    return result->patterns[a] < result->patterns[b];
  });
  MineResult* sorted = new MineResult();
  for (size_t i : order) {
    sorted->patterns.push_back(std::move(result->patterns[i]));
    sorted->freqs.push_back(result->freqs[i]);
  }
  delete result;
  delete g_last_mine;
  g_last_mine = sorted;
  return static_cast<int64_t>(sorted->patterns.size());
}

int64_t patterns_total_len() {
  int64_t total = 0;
  for (const auto& p : g_last_mine->patterns) total += p.size();
  return total;
}

// Copy mined patterns out as CSR (flat items, offsets, freqs).
void get_patterns(int32_t* flat_out, int64_t* offsets_out, int64_t* freqs_out) {
  int64_t pos = 0;
  int64_t n = static_cast<int64_t>(g_last_mine->patterns.size());
  for (int64_t i = 0; i < n; ++i) {
    offsets_out[i] = pos;
    const auto& p = g_last_mine->patterns[i];
    std::memcpy(flat_out + pos, p.data(), p.size() * sizeof(int32_t));
    pos += p.size();
    freqs_out[i] = g_last_mine->freqs[i];
  }
  offsets_out[n] = pos;
}

// Subsequence check: pattern (greedy left-to-right) inside seq.
static bool is_subsequence(const int32_t* pat, int64_t plen, const int32_t* seq,
                           int64_t slen) {
  int64_t i = 0;
  for (int64_t j = 0; j < slen && i < plen; ++j) {
    if (seq[j] == pat[i]) ++i;
  }
  return i == plen;
}

// Match each sequence against the pattern set (CSR patterns), keeping at most
// max_matches randomly-ordered matches per sequence.
int64_t match_pairs(const int32_t* seq_flat, const int64_t* seq_offsets,
                    int64_t num_seqs, const int32_t* pat_flat,
                    const int64_t* pat_offsets, int64_t num_pats,
                    int64_t max_matches, uint64_t seed, int64_t n_jobs) {
  // inverted index: (first, second) item pair -> pattern indices
  std::unordered_map<uint64_t, std::vector<int64_t>> index;
  index.reserve(num_pats * 2);
  for (int64_t p = 0; p < num_pats; ++p) {
    const int32_t* pat = pat_flat + pat_offsets[p];
    int64_t plen = pat_offsets[p + 1] - pat_offsets[p];
    if (plen < 2) continue;
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(pat[0])) << 32) |
                   static_cast<uint32_t>(pat[1]);
    index[key].push_back(p);
  }

  auto* result = new MatchResult();
  std::vector<std::vector<int64_t>> per_seq(num_seqs);

#ifdef _OPENMP
  int threads = n_jobs > 0 ? static_cast<int>(n_jobs) : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads)
#endif
  for (int64_t s = 0; s < num_seqs; ++s) {
    const int32_t* seq = seq_flat + seq_offsets[s];
    int64_t slen = seq_offsets[s + 1] - seq_offsets[s];
    std::unordered_set<int64_t> matched;
    // candidate buckets: every ordered (i < j) item pair in the sequence
    for (int64_t i = 0; i + 1 < slen; ++i) {
      for (int64_t j = i + 1; j < slen; ++j) {
        uint64_t key =
            (static_cast<uint64_t>(static_cast<uint32_t>(seq[i])) << 32) |
            static_cast<uint32_t>(seq[j]);
        auto it = index.find(key);
        if (it == index.end()) continue;
        for (int64_t p : it->second) {
          if (matched.count(p)) continue;
          const int32_t* pat = pat_flat + pat_offsets[p];
          int64_t plen = pat_offsets[p + 1] - pat_offsets[p];
          // first two already matched at i<j; check the rest after j
          if (plen == 2 || is_subsequence(pat + 2, plen - 2, seq + j + 1,
                                          slen - j - 1)) {
            matched.insert(p);
          }
        }
      }
    }
    std::vector<int64_t> matches(matched.begin(), matched.end());
    std::sort(matches.begin(), matches.end());
    // seeded shuffle (splitmix-style LCG) then truncate — mirrors the
    // reference's shuffle(patterns); cnt==10 break
    uint64_t state = seed ^ (0x9e3779b97f4a7c15ull * (s + 1));
    for (int64_t i = static_cast<int64_t>(matches.size()) - 1; i > 0; --i) {
      state = state * 6364136223846793005ull + 1442695040888963407ull;
      int64_t j = static_cast<int64_t>((state >> 33) % (i + 1));
      std::swap(matches[i], matches[j]);
    }
    if (static_cast<int64_t>(matches.size()) > max_matches)
      matches.resize(max_matches);
    per_seq[s] = std::move(matches);
  }

  result->offsets.push_back(0);
  for (int64_t s = 0; s < num_seqs; ++s) {
    for (int64_t p : per_seq[s]) result->flat.push_back(p);
    result->offsets.push_back(static_cast<int64_t>(result->flat.size()));
  }
  delete g_last_match;
  g_last_match = result;
  return static_cast<int64_t>(result->flat.size());
}

void get_matches(int64_t* flat_out, int64_t* offsets_out) {
  std::memcpy(flat_out, g_last_match->flat.data(),
              g_last_match->flat.size() * sizeof(int64_t));
  std::memcpy(offsets_out, g_last_match->offsets.data(),
              g_last_match->offsets.size() * sizeof(int64_t));
}

void free_results() {
  delete g_last_mine;
  g_last_mine = nullptr;
  delete g_last_match;
  g_last_match = nullptr;
}

}  // extern "C"
