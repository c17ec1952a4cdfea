// Banded weighted DTW (MrMsDTW refinement levels).
//
// DP over a diagonal band: row i of the cost band covers matrix columns
// [centers[i]-w, centers[i]+w]. Step set {(0,1), (1,0), (1,1)} with weights
// {w_h, w_v, w_d} (synctoolbox step weights 1.5/1.5/2.0 — reference
// etude/data/aligner.py:43-45). O(N * (2w+1)) time and memory, vs O(N*M)
// for the full matrix. Traceback codes are written to out_codes and the
// path is walked by the Python caller.
//
// The port's own copy of etude_tpu/native/dtw_band.cc. Built with g++ at
// first use by etude_tpu_torch/ops/_build.py into build/kernels/ and called
// through ctypes (etude_tpu_torch/ops/dtw.py `dtw_band_native`).

#include <cstdint>
#include <limits>

extern "C" {

// cost_band: [N, 2w+1] row-major; band column k maps to matrix column
//            centers[i] + k - w. Cells outside [0, M) must be pre-masked to
//            a large value by the caller (they are also re-checked here).
// centers:   [N] monotone non-decreasing band centers.
// out_codes: [N, 2w+1] uint8 traceback: 0=(0,1) horizontal, 1=(1,0)
//            vertical, 2=(1,1) diagonal, 255=unreachable.
// Returns the accumulated cost at (N-1, M-1), or +inf if unreachable.
double dtw_band(const float* cost_band,
                int64_t n, int64_t m, int64_t w,
                const int64_t* centers,
                float w_h, float w_v, float w_d,
                uint8_t* out_codes) {
    const int64_t bw = 2 * w + 1;
    const double INF = std::numeric_limits<double>::infinity();

    double* prev = new double[bw];
    double* curr = new double[bw];

    // Row 0: only horizontal accumulation from (0, 0).
    for (int64_t k = 0; k < bw; ++k) { prev[k] = INF; out_codes[k] = 255; }
    {
        const int64_t c0 = centers[0];
        for (int64_t k = 0; k < bw; ++k) {
            const int64_t j = c0 + k - w;
            if (j < 0 || j >= m) continue;
            const double c = static_cast<double>(cost_band[k]);
            if (j == 0) {
                prev[k] = c;            // D(0,0) = cost(0,0)
                out_codes[k] = 255;     // path start
            } else if (k > 0 && prev[k - 1] < INF) {
                prev[k] = prev[k - 1] + w_h * c;
                out_codes[k] = 0;
            }
        }
    }

    for (int64_t i = 1; i < n; ++i) {
        const int64_t dc = centers[i] - centers[i - 1];
        const float* row = cost_band + i * bw;
        uint8_t* codes = out_codes + i * bw;
        for (int64_t k = 0; k < bw; ++k) {
            curr[k] = INF;
            codes[k] = 255;
            const int64_t j = centers[i] + k - w;
            if (j < 0 || j >= m) continue;
            const double c = static_cast<double>(row[k]);

            double best = INF;
            uint8_t code = 255;
            // Vertical (i-1, j): band index k + dc in the previous row.
            const int64_t kv = k + dc;
            if (kv >= 0 && kv < bw && prev[kv] < INF) {
                const double v = prev[kv] + w_v * c;
                if (v < best) { best = v; code = 1; }
            }
            // Diagonal (i-1, j-1): band index k + dc - 1.
            const int64_t kd = k + dc - 1;
            if (kd >= 0 && kd < bw && prev[kd] < INF) {
                const double v = prev[kd] + w_d * c;
                if (v < best) { best = v; code = 2; }
            }
            // Horizontal (i, j-1): band index k - 1 in the current row
            // (already computed: k scans left to right).
            if (k > 0 && curr[k - 1] < INF) {
                const double v = curr[k - 1] + w_h * c;
                if (v < best) { best = v; code = 0; }
            }
            curr[k] = best;
            codes[k] = code;
        }
        double* tmp = prev; prev = curr; curr = tmp;
    }

    // Final cell (N-1, M-1).
    const int64_t k_end = (m - 1) - centers[n - 1] + w;
    double result = (k_end >= 0 && k_end < bw) ? prev[k_end] : INF;
    delete[] prev;
    delete[] curr;
    return result;
}

}  // extern "C"
