// smo: the dual solver of libsvm (Fan, Chen and Lin's SMO with second-order
// working-set selection) for the port's SVC and SVR, on the host.
//
// Solves   min_a 0.5 a'Qa + p'a   subject to  y'a = 0,  0 <= a_i <= C_i
// with Q_ij = y_i y_j K[idx_i, idx_j], K an n x n kernel matrix (row-major,
// float64) and idx mapping the l variables onto its rows: an SVC pair takes
// the rows of its two classes, an epsilon-SVR the n rows twice (y = +1, then
// -1). The iteration is libsvm's Solver::Solve without shrinking (which only
// changes the path, not the optimum): select i, j as select_working_set does
// (ties to the last index), update the pair analytically with clipping,
// update the gradient, stop when the maximal violation falls below eps.
// rho is libsvm's calculate_rho.
//
// C ABI (ctypes, flexynesis_torch/utils/classical/svm.py; built with g++ by
// flexynesis_torch/kernels/build.py):
//   long smo_solve(long l, const double* K, long n, const long* idx,
//                  const double* p, const double* y, const double* C,
//                  double eps, long max_iter, double* alpha, double* rho)
// returns the number of iterations, or -1 when max_iter ran out.

#include <cmath>
#include <limits>
#include <vector>

namespace {

constexpr double TAU = 1e-12;
constexpr double INF = std::numeric_limits<double>::infinity();

struct Problem {
    long l;
    const double* K;
    long n;
    const long* idx;
    const double* y;
    double q(long i, long j) const { return y[i] * y[j] * K[idx[i] * n + idx[j]]; }
};

}  // namespace

extern "C" long smo_solve(long l, const double* K, long n, const long* idx, const double* p,
                          const double* y, const double* C, double eps, long max_iter,
                          double* alpha, double* rho) {
    Problem pr{l, K, n, idx, y};
    std::vector<double> G(p, p + l), QD(l), Qi(l), Qj(l);
    for (long t = 0; t < l; ++t) {
        QD[t] = pr.q(t, t);
        alpha[t] = 0.0;
    }
    auto upper = [&](long t) { return alpha[t] >= C[t]; };
    auto lower = [&](long t) { return alpha[t] <= 0.0; };
    long iter = 0;
    for (; iter < max_iter; ++iter) {
        // select_working_set: i maximises -y_t G_t over I_up
        double Gmax = -INF, Gmax2 = -INF, obj_min = INF;
        long i = -1, j = -1;
        for (long t = 0; t < l; ++t) {
            if (y[t] > 0) {
                if (!upper(t) && -G[t] >= Gmax) { Gmax = -G[t]; i = t; }
            } else {
                if (!lower(t) && G[t] >= Gmax) { Gmax = G[t]; i = t; }
            }
        }
        if (i >= 0)
            for (long t = 0; t < l; ++t) Qi[t] = pr.q(i, t);
        for (long t = 0; t < l && i >= 0; ++t) {
            double grad_diff, quad;
            if (y[t] > 0) {
                if (lower(t)) continue;
                grad_diff = Gmax + G[t];
                if (G[t] >= Gmax2) Gmax2 = G[t];
                quad = QD[i] + QD[t] - 2.0 * y[i] * Qi[t];
            } else {
                if (upper(t)) continue;
                grad_diff = Gmax - G[t];
                if (-G[t] >= Gmax2) Gmax2 = -G[t];
                quad = QD[i] + QD[t] + 2.0 * y[i] * Qi[t];
            }
            if (grad_diff > 0) {
                double obj = -(grad_diff * grad_diff) / (quad > 0 ? quad : TAU);
                if (obj <= obj_min) { j = t; obj_min = obj; }
            }
        }
        if (i < 0 || j < 0 || Gmax + Gmax2 < eps) break;

        for (long t = 0; t < l; ++t) Qj[t] = pr.q(j, t);
        double Ci = C[i], Cj = C[j];
        double old_i = alpha[i], old_j = alpha[j];
        if (y[i] != y[j]) {
            double quad = QD[i] + QD[j] + 2.0 * Qi[j];
            if (quad <= 0) quad = TAU;
            double delta = (-G[i] - G[j]) / quad;
            double diff = alpha[i] - alpha[j];
            alpha[i] += delta;
            alpha[j] += delta;
            if (diff > 0) {
                if (alpha[j] < 0) { alpha[j] = 0; alpha[i] = diff; }
            } else {
                if (alpha[i] < 0) { alpha[i] = 0; alpha[j] = -diff; }
            }
            if (diff > Ci - Cj) {
                if (alpha[i] > Ci) { alpha[i] = Ci; alpha[j] = Ci - diff; }
            } else {
                if (alpha[j] > Cj) { alpha[j] = Cj; alpha[i] = Cj + diff; }
            }
        } else {
            double quad = QD[i] + QD[j] - 2.0 * Qi[j];
            if (quad <= 0) quad = TAU;
            double delta = (G[i] - G[j]) / quad;
            double sum = alpha[i] + alpha[j];
            alpha[i] -= delta;
            alpha[j] += delta;
            if (sum > Ci) {
                if (alpha[i] > Ci) { alpha[i] = Ci; alpha[j] = sum - Ci; }
            } else {
                if (alpha[j] < 0) { alpha[j] = 0; alpha[i] = sum; }
            }
            if (sum > Cj) {
                if (alpha[j] > Cj) { alpha[j] = Cj; alpha[i] = sum - Cj; }
            } else {
                if (alpha[i] < 0) { alpha[i] = 0; alpha[j] = sum; }
            }
        }
        double di = alpha[i] - old_i, dj = alpha[j] - old_j;
        for (long t = 0; t < l; ++t) G[t] += Qi[t] * di + Qj[t] * dj;
    }

    // calculate_rho
    double ub = INF, lb = -INF, sum_free = 0.0;
    long nr_free = 0;
    for (long t = 0; t < l; ++t) {
        double yG = y[t] * G[t];
        if (upper(t)) {
            if (y[t] < 0) ub = std::fmin(ub, yG); else lb = std::fmax(lb, yG);
        } else if (lower(t)) {
            if (y[t] > 0) ub = std::fmin(ub, yG); else lb = std::fmax(lb, yG);
        } else {
            ++nr_free;
            sum_free += yG;
        }
    }
    *rho = nr_free > 0 ? sum_free / nr_free : (ub + lb) / 2;
    return iter < max_iter ? iter : -1;
}
