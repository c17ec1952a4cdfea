// Host Viterbi decoder for the beat/downbeat DBN of etude_tpu_torch.
//
// The port's own copy of the JAX package's etude_tpu/native/dbn_viterbi.cc
// (the decoder that replaced the reference's native madmom Cython decoder,
// reference: etude/data/beat_detector.py:19-20). The state space is
// contiguous (block-major, interval-major, phase): every non-boundary state
// has exactly one predecessor (its phase neighbor), and boundary (first)
// states take the max-product over the previous block's last states with
// the tempo transition matrix. Backtrace runs natively and emits the full
// state path.
//
// Built as a shared library with g++ at first use by
// etude_tpu_torch/ops/_build.py and called through ctypes from
// etude_tpu_torch/ops/dbn.py. It is host code, not a GPU kernel, and the
// port has no other decoder.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr float kNegInf = -1e30f;
}

extern "C" {

// cols:       [T * n_cols] row-major per-frame observation log densities
//             (e.g. {no-beat, beat, downbeat} columns); the madmom-style
//             state space emits one of a handful of densities per state, so
//             the full [T, S] observation matrix is never materialized
// ptr:        [S] column index each state emits
// first_idx:  [n_blocks * n_tempi] state index of each (block, tempo) first state
// last_idx:   [n_blocks * n_tempi] state index of each (block, tempo) last state
// logT:       [n_tempi * n_tempi] tempo-change log probabilities
// out_path:   [T] best state per frame (written)
// Returns the final best log probability.
double dbn_viterbi(const float* cols, int64_t n_cols, const int8_t* ptr,
                   int64_t T, int64_t S,
                   const int64_t* first_idx, const int64_t* last_idx,
                   int64_t n_blocks, int64_t n_tempi, const float* logT,
                   int64_t* out_path) {
  if (T <= 0 || S <= 0) return -std::numeric_limits<double>::infinity();
  const int64_t F = n_blocks * n_tempi;

  std::vector<float> score(S), next(S);
  for (int64_t s = 0; s < S; ++s) score[s] = cols[ptr[s]];

  // Boundary backpointers: predecessor tempo per (frame, block, tempo).
  std::vector<int32_t> backs(static_cast<size_t>(T) * F, 0);

  std::vector<char> is_first(S, 0);
  for (int64_t f = 0; f < F; ++f) is_first[first_idx[f]] = 1;

  for (int64_t t = 1; t < T; ++t) {
    // Phase advance: next[s] = score[s-1] for non-boundary states.
    next[0] = kNegInf;
    std::memcpy(next.data() + 1, score.data(), (S - 1) * sizeof(float));

    // Boundary states: max over predecessor tempi of the previous block.
    // Iterate `from` outermost so the inner loop walks a contiguous logT row
    // (auto-vectorizes under -O3).
    int32_t* bt = backs.data() + static_cast<size_t>(t) * F;
    std::vector<float> best(n_tempi);
    std::vector<int32_t> best_from(n_tempi);
    for (int64_t b = 0; b < n_blocks; ++b) {
      const int64_t prev_b = (b - 1 + n_blocks) % n_blocks;
      const int64_t* prev_last = last_idx + prev_b * n_tempi;
      const int64_t* cur_first = first_idx + b * n_tempi;
      std::fill(best.begin(), best.end(), kNegInf);
      std::fill(best_from.begin(), best_from.end(), 0);
      for (int64_t from = 0; from < n_tempi; ++from) {
        const float base = score[prev_last[from]];
        const float* row = logT + from * n_tempi;
        for (int64_t to = 0; to < n_tempi; ++to) {
          const float cand = base + row[to];
          if (cand > best[to]) {
            best[to] = cand;
            best_from[to] = static_cast<int32_t>(from);
          }
        }
      }
      for (int64_t to = 0; to < n_tempi; ++to) {
        next[cur_first[to]] = best[to];
        bt[b * n_tempi + to] = best_from[to];
      }
    }

    const float* cols_t = cols + static_cast<size_t>(t) * n_cols;
    for (int64_t s = 0; s < S; ++s) next[s] += cols_t[ptr[s]];
    score.swap(next);
  }

  // Argmax of the final frame, then backtrace.
  int64_t s = 0;
  for (int64_t i = 1; i < S; ++i)
    if (score[i] > score[s]) s = i;
  const double log_prob = score[s];

  // Map first-state index → (block, tempo) for O(1) boundary lookups.
  std::vector<int64_t> first_of(S, -1);
  for (int64_t f = 0; f < F; ++f) first_of[first_idx[f]] = f;

  out_path[T - 1] = s;
  for (int64_t t = T - 2; t >= 0; --t) {
    const int64_t f = first_of[s];
    if (f >= 0) {
      const int64_t b = f / n_tempi;
      const int64_t to = f % n_tempi;
      const int64_t prev_b = (b - 1 + n_blocks) % n_blocks;
      const int32_t from = backs[static_cast<size_t>(t + 1) * F + b * n_tempi + to];
      s = last_idx[prev_b * n_tempi + from];
    } else {
      s -= 1;
    }
    out_path[t] = s;
  }
  return log_prob;
}

}  // extern "C"
