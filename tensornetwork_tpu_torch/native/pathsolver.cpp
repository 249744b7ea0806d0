// Native contraction-order solver: exact optimal pairwise contraction
// order by dynamic programming over subsets of the network graph
// (netcon-style, Pfeifer et al.; the Python branch-and-bound in
// contractors/custom_path_solvers.py is exponential in a much worse way
// and tops out around n=8).  Host code: built by g++ at first use
// (native/__init__.py), never by nvcc.
//
// Cost model matches the Python solvers: adj is an (n, n) log10
// adjacency matrix, adj[i][j] = log10(shared dim), adj[i][i] = log10
// (open dim).  Total cost = sum over pairwise steps of the product of
// all dims involved (linear domain), reported as log10.
//
// Identity used: with size(S) = log10 size of the tensor obtained by
// merging subset S,   pair_cost(S1, S2) = (size(S1) + size(S2) +
// size(S1|S2)) / 2   — so the DP needs only the per-subset sizes.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <limits>

extern "C" {

// Returns 0 on success.  pairs_out must hold 2*(n-1) int64 (maskA, maskB
// per merge, post-order); cost_out receives log10 total cost.
int tn_optimal_order(const double* adj, int n, int64_t* pairs_out,
                     double* cost_out) {
    if (n < 1 || n > 26) return 1;
    if (n == 1) { *cost_out = 0.0; return 0; }
    const uint32_t full = (n >= 32) ? 0u : ((1u << n) - 1u);
    const size_t m = size_t(1) << n;

    std::vector<double> size_log(m, 0.0);   // log10 tensor size of S
    std::vector<double> cost_lin(m, 0.0);   // linear total cost of S
    std::vector<uint32_t> split(m, 0);      // argmin submask

    // single-node sizes
    std::vector<double> row_total(n, 0.0);
    for (int i = 0; i < n; ++i) {
        double t = 0.0;
        for (int k = 0; k < n; ++k) t += adj[i * n + k];
        row_total[i] = t;                   // open + all shared
        size_log[size_t(1) << i] = t;
    }

    // subset sizes: size(S) = size(S\{i}) + size({i}) - 2*x({i}, S\{i})
    for (uint32_t S = 1; S <= full; ++S) {
        if ((S & (S - 1)) == 0) continue;   // singleton, done
        int i = __builtin_ctz(S);
        uint32_t T = S & (S - 1);           // S without lowest bit
        double x = 0.0;
        uint32_t t = T;
        while (t) {
            int j = __builtin_ctz(t);
            x += adj[i * n + j];
            t &= t - 1;
        }
        size_log[S] = size_log[T] + row_total[i] - 2.0 * x;
    }

    const double INF = std::numeric_limits<double>::infinity();
    // DP over subsets in increasing popcount order implicitly: submask
    // enumeration only needs values of proper submasks, and S1, S2 < S.
    for (uint32_t S = 1; S <= full; ++S) {
        if ((S & (S - 1)) == 0) continue;
        double best = INF;
        uint32_t best_s1 = 0;
        bool found_connected = false;
        // pass 1: connected splits only (x(S1,S2) > 0)
        for (int pass = 0; pass < 2 && best == INF; ++pass) {
            for (uint32_t S1 = (S - 1) & S; S1; S1 = (S1 - 1) & S) {
                uint32_t S2 = S & ~S1;
                if (S1 > S2) continue;      // each split once
                double x2 = (size_log[S1] + size_log[S2] - size_log[S])
                            * 0.5;
                bool connected = x2 > 1e-12;
                if (pass == 0 && !connected) continue;
                double pc = (size_log[S1] + size_log[S2] + size_log[S])
                            * 0.5;
                double total = cost_lin[S1] + cost_lin[S2]
                               + std::pow(10.0, pc);
                if (total < best) {
                    best = total;
                    best_s1 = S1;
                    found_connected = connected;
                }
            }
        }
        (void)found_connected;
        cost_lin[S] = best;
        split[S] = best_s1;
    }

    // reconstruct post-order merges
    int out_idx = 0;
    // iterative post-order on the split tree
    std::vector<uint32_t> stack;
    std::vector<uint32_t> post;
    stack.push_back(full);
    while (!stack.empty()) {
        uint32_t S = stack.back(); stack.pop_back();
        if ((S & (S - 1)) == 0) continue;
        post.push_back(S);
        stack.push_back(split[S]);
        stack.push_back(S & ~split[S]);
    }
    // children before parents
    for (auto it = post.rbegin(); it != post.rend(); ++it) {
        uint32_t S = *it;
        pairs_out[2 * out_idx] = (int64_t)split[S];
        pairs_out[2 * out_idx + 1] = (int64_t)(S & ~split[S]);
        ++out_idx;
    }
    if (out_idx != n - 1) return 2;
    *cost_out = std::log10(cost_lin[full]);
    return 0;
}

}  // extern "C"
