// Polyphase FIR resampling core (upfirdn inner loop), threaded.
//
// The port's own copy of etude_tpu/native/resample_fir.cc. Built with g++ at
// first use by etude_tpu_torch/ops/_build.py into build/kernels/ (with the
// JAX package's flags, so both libraries give the same bits) and called
// through ctypes (etude_tpu_torch/ops/resample.py `upfirdn_poly_native`).
// It takes scipy.signal.resample_poly's place on the serving path: the
// audio's 44.1 kHz -> 16 kHz leg for Extract and 22.05 kHz leg for the
// volume map. The filter design and scipy-exact padding/trim bookkeeping
// stay in Python (ops/resample.py); this kernel evaluates only the
// polyphase dot products
//
//     y[n] = sum_t hp_rev[phase(n)][t] * x[base(n) - K + 1 + t]
//
// with phase(n) = (n*down) % up and base(n) = (n*down) / up, which is
// algebraically identical to scipy's upfirdn (zero beyond the signal edges).
//
// hp_rev: [up, K] float32, the k-reversed polyphase decomposition of the
// zero-padded filter (built in Python). Outputs n in [n_start, n_start+n_out)
// are striped across threads.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

void run_range(const float* hp_rev, int64_t K, const float* x, int64_t Lx,
               int64_t up, int64_t down, int64_t n_start, float* y,
               int64_t i_lo, int64_t i_hi) {
  for (int64_t i = i_lo; i < i_hi; ++i) {
    const int64_t n = n_start + i;
    const int64_t nd = n * down;
    const int64_t phase = nd % up;
    const int64_t base = nd / up;
    const float* h = hp_rev + phase * K;
    // x index for tap t is base - K + 1 + t; keep it inside [0, Lx).
    const int64_t t_lo = std::max<int64_t>(0, K - 1 - base);
    const int64_t t_hi = std::min<int64_t>(K, Lx - base + K - 1);
    const float* xs = x + base - K + 1;
    float acc = 0.0f;
    for (int64_t t = t_lo; t < t_hi; ++t) acc += h[t] * xs[t];
    y[i] = acc;
  }
}

}  // namespace

extern "C" void upfirdn_poly_f32(const float* hp_rev, int64_t up, int64_t K,
                                 const float* x, int64_t Lx, int64_t down,
                                 int64_t n_start, int64_t n_out, float* y,
                                 int64_t n_threads) {
  if (n_out <= 0) return;
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  n_threads = std::max<int64_t>(1, std::min({n_threads, hw, n_out}));
  if (n_threads == 1) {
    run_range(hp_rev, K, x, Lx, up, down, n_start, y, 0, n_out);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t chunk = (n_out + n_threads - 1) / n_threads;
  for (int64_t w = 0; w < n_threads; ++w) {
    const int64_t lo = w * chunk;
    const int64_t hi = std::min(n_out, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(run_range, hp_rev, K, x, Lx, up, down, n_start, y,
                         lo, hi);
  }
  for (auto& t : workers) t.join();
}
