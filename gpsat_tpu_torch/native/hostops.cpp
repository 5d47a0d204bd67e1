// Native host-side hot ops for gpsat_tpu_torch (copy of
// gpsat_tpu/native/hostops.cpp).
//
// The reference accelerates two host-side kernels with numba JIT
// (reference: GPSat/prediction_locations.py:18 `_max_dist_bool` over ~1e8
// candidate rows; GPSat/postprocessing.py:22 `gaussian_2d_weight`,
// target='parallel'). numba is not part of this stack; these are the C++
// equivalents, built as a small shared library driven through ctypes with
// OpenMP parallel loops. The device-side smoother in
// gpsat_tpu_torch/postprocessing.py remains the primary path; these serve the
// pure-host pipeline (prediction-location culling, CPU-only deployments) and
// an independent f64 check of the device smoother.

#include <cmath>
#include <cstdint>

extern "C" {

// Bool mask of rows of locs [n, d] within euclidean max_dist of ref [d].
// Same per-dimension prefilter the reference's gufunc uses: a point further
// than max_dist along any single axis cannot be inside the ball.
void max_dist_bool(const double* locs, const double* ref, double max_dist,
                   int64_t n, int64_t d, uint8_t* out) {
    const double md2 = max_dist * max_dist;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double* row = locs + i * d;
        double acc = 0.0;
        uint8_t keep = 1;
        for (int64_t j = 0; j < d; ++j) {
            const double diff = row[j] - ref[j];
            const double dj2 = diff * diff;
            if (dj2 >= md2) { keep = 0; break; }
            acc += dj2;
            if (acc >= md2) { keep = 0; break; }
        }
        out[i] = keep;
    }
}

// Gaussian-weighted smooth: out[i] = sum_j w_ij v_j / sum_j w_ij with
// w_ij = exp(-(((x_j-x0_i)/l_x)^2 + ((y_j-y0_i)/l_y)^2)/2), NaN v skipped.
void gaussian_2d_weight(const double* x0, const double* y0, int64_t n_out,
                        const double* x, const double* y, const double* vals,
                        int64_t n_in, double l_x, double l_y, double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_out; ++i) {
        double w_sum = 0.0, w_val = 0.0;
        for (int64_t j = 0; j < n_in; ++j) {
            const double v = vals[j];
            if (std::isnan(v)) continue;
            const double dx = (x[j] - x0[i]) / l_x;
            const double dy = (y[j] - y0[i]) / l_y;
            const double w = std::exp(-0.5 * (dx * dx + dy * dy));
            w_sum += w;
            w_val += w * v;
        }
        out[i] = (w_sum == 0.0) ? NAN : (w_val / w_sum);
    }
}

// Gaussian-distance weighted merge accumulators for overlapping expert
// predictions (reference: GPSat/utils.py:2081 get_weighted_values inner
// loop): given group ids [n] (0..g-1), squared distances d2 [n] and values
// v [n], accumulate sum_w and sum_wv per group.
void weighted_merge_accumulate(const int64_t* group, const double* d2,
                               const double* v, int64_t n, double inv_2l2,
                               int64_t n_groups, double* sum_w,
                               double* sum_wv) {
    for (int64_t g = 0; g < n_groups; ++g) { sum_w[g] = 0.0; sum_wv[g] = 0.0; }
    for (int64_t i = 0; i < n; ++i) {
        const double w = std::exp(-d2[i] * inv_2l2);
        sum_w[group[i]] += w;
        sum_wv[group[i]] += w * v[i];
    }
}

}  // extern "C"
