// Native hot-path kernels for the host-side graph pipeline.
//
// Implements the same algorithms as graphgpt_tpu/data/euler.py (randomized
// Hierholzer Euler tours with exact odd-node matching; reference semantics:
// alibaba/graph-gpt src/utils/nx_utils.py:388-422) and
// graphgpt_tpu/data/sampling.py ego_k_hop, at C++ speed. Exposed with a
// plain C ABI for ctypes binding — no pybind11 dependency.
//
// Build: g++ -O3 -march=native -shared -fPIC euler.cpp -o libggtnative.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <random>
#include <vector>

namespace {

using std::vector;

struct Rng {
    std::mt19937_64 gen;
    explicit Rng(uint64_t seed) : gen(seed) {}
    int64_t below(int64_t n) {
        return (int64_t)(gen() % (uint64_t)n);
    }
    template <typename T>
    void shuffle(vector<T>& v) {
        for (int64_t i = (int64_t)v.size() - 1; i > 0; --i) {
            std::swap(v[i], v[(size_t)below(i + 1)]);
        }
    }
};

// Undirected simple edge list from a directed edge_index.
static void simplify_edges(int64_t n, int64_t m, const int64_t* src,
                           const int64_t* dst, vector<int64_t>& eu,
                           vector<int64_t>& ev) {
    vector<uint64_t> keys;
    keys.reserve((size_t)m);
    for (int64_t e = 0; e < m; ++e) {
        int64_t a = src[e], b = dst[e];
        if (a == b) continue;  // drop self loops
        int64_t lo = a < b ? a : b, hi = a < b ? b : a;
        keys.push_back((uint64_t)lo * (uint64_t)n + (uint64_t)hi);
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    eu.resize(keys.size());
    ev.resize(keys.size());
    for (size_t i = 0; i < keys.size(); ++i) {
        eu[i] = (int64_t)(keys[i] / (uint64_t)n);
        ev[i] = (int64_t)(keys[i] % (uint64_t)n);
    }
}

struct Adj {
    vector<int64_t> indptr, nbr, eid;
    void build(int64_t n, const vector<int64_t>& eu, const vector<int64_t>& ev) {
        int64_t m = (int64_t)eu.size();
        indptr.assign((size_t)n + 1, 0);
        for (int64_t e = 0; e < m; ++e) {
            indptr[(size_t)eu[e] + 1]++;
            indptr[(size_t)ev[e] + 1]++;
        }
        for (int64_t i = 0; i < n; ++i) indptr[(size_t)i + 1] += indptr[(size_t)i];
        nbr.resize((size_t)(2 * m));
        eid.resize((size_t)(2 * m));
        vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
        for (int64_t e = 0; e < m; ++e) {
            nbr[(size_t)fill[(size_t)eu[e]]] = ev[e];
            eid[(size_t)fill[(size_t)eu[e]]++] = e;
            nbr[(size_t)fill[(size_t)ev[e]]] = eu[e];
            eid[(size_t)fill[(size_t)ev[e]]++] = e;
        }
    }
};

// BFS parent tree over the component containing src.
static void bfs_tree(const Adj& adj, int64_t src, vector<int64_t>& parent,
                     vector<int64_t>& scratch) {
    scratch.clear();
    scratch.push_back(src);
    parent[(size_t)src] = -1;
    for (size_t qi = 0; qi < scratch.size(); ++qi) {
        int64_t node = scratch[qi];
        for (int64_t p = adj.indptr[(size_t)node]; p < adj.indptr[(size_t)node + 1]; ++p) {
            int64_t nb = adj.nbr[(size_t)p];
            if (parent[(size_t)nb] == -2) {
                parent[(size_t)nb] = node;
                scratch.push_back(nb);
            }
        }
    }
}

// Exact min-weight perfect matching over <= 14 odd nodes (bitmask DP).
static void min_weight_pairs(const vector<vector<double>>& dist,
                             vector<std::pair<int, int>>& pairs) {
    int k = (int)dist.size();
    int full = (1 << k) - 1;
    vector<double> best((size_t)(1 << k), 1e30);
    vector<int> ci((size_t)(1 << k), -1), cj((size_t)(1 << k), -1),
        cp((size_t)(1 << k), -1);
    best[0] = 0.0;
    for (int mask = 0; mask <= full; ++mask) {
        if (best[(size_t)mask] >= 1e30) continue;
        int i = 0;
        while (i < k && ((mask >> i) & 1)) ++i;
        if (i >= k) continue;
        for (int j = i + 1; j < k; ++j) {
            if ((mask >> j) & 1) continue;
            int nmask = mask | (1 << i) | (1 << j);
            double cand = best[(size_t)mask] + dist[(size_t)i][(size_t)j];
            if (cand < best[(size_t)nmask]) {
                best[(size_t)nmask] = cand;
                ci[(size_t)nmask] = i;
                cj[(size_t)nmask] = j;
                cp[(size_t)nmask] = mask;
            }
        }
    }
    int mask = full;
    while (mask) {
        pairs.emplace_back(ci[(size_t)mask], cj[(size_t)mask]);
        mask = cp[(size_t)mask];
    }
}

// Hierholzer over a multigraph edge list; returns node walk.
static void hierholzer(int64_t n, const vector<int64_t>& eu,
                       const vector<int64_t>& ev, int64_t start, Rng& rng,
                       vector<int64_t>& walk) {
    int64_t m = (int64_t)eu.size();
    // adjacency with randomized order
    vector<vector<std::pair<int64_t, int64_t>>> adj((size_t)n);
    for (int64_t e = 0; e < m; ++e) {
        adj[(size_t)eu[e]].push_back({ev[e], e});
        adj[(size_t)ev[e]].push_back({eu[e], e});
    }
    for (auto& lst : adj) rng.shuffle(lst);
    vector<char> used((size_t)m, 0);
    vector<int64_t> ptr((size_t)n, 0);
    vector<int64_t> stack;
    stack.push_back(start);
    vector<int64_t> tour;
    while (!stack.empty()) {
        int64_t v = stack.back();
        auto& lst = adj[(size_t)v];
        bool advanced = false;
        while (ptr[(size_t)v] < (int64_t)lst.size()) {
            auto [nb, e] = lst[(size_t)ptr[(size_t)v]];
            if (used[(size_t)e]) {
                ptr[(size_t)v]++;
                continue;
            }
            used[(size_t)e] = 1;
            stack.push_back(nb);
            advanced = true;
            break;
        }
        if (!advanced) {
            tour.push_back(v);
            stack.pop_back();
        }
    }
    walk.assign(tour.rbegin(), tour.rend());
}

}  // namespace

extern "C" {

// Euler walk over the whole graph (component shuffle + jump joins).
// walk_out capacity must be >= 2 * num_undirected_edges + num_nodes + 2.
// Returns the walk length (number of nodes in the walk), or -1 on error.
int64_t ggt_euler_walk(int64_t num_nodes, int64_t num_directed_edges,
                       const int64_t* edge_src, const int64_t* edge_dst,
                       uint64_t seed, int64_t* walk_out) {
    Rng rng(seed);
    vector<int64_t> eu, ev;
    simplify_edges(num_nodes, num_directed_edges, edge_src, edge_dst, eu, ev);
    Adj adj;
    adj.build(num_nodes, eu, ev);

    // connected components
    vector<int64_t> comp((size_t)num_nodes, -1);
    vector<vector<int64_t>> comps;
    vector<int64_t> q;
    for (int64_t s = 0; s < num_nodes; ++s) {
        if (comp[(size_t)s] != -1) continue;
        int64_t cid = (int64_t)comps.size();
        comps.push_back({});
        q.clear();
        q.push_back(s);
        comp[(size_t)s] = cid;
        for (size_t qi = 0; qi < q.size(); ++qi) {
            int64_t node = q[qi];
            comps[(size_t)cid].push_back(node);
            for (int64_t p = adj.indptr[(size_t)node];
                 p < adj.indptr[(size_t)node + 1]; ++p) {
                int64_t nb = adj.nbr[(size_t)p];
                if (comp[(size_t)nb] == -1) {
                    comp[(size_t)nb] = cid;
                    q.push_back(nb);
                }
            }
        }
    }
    vector<int64_t> order((size_t)comps.size());
    for (size_t i = 0; i < comps.size(); ++i) order[i] = (int64_t)i;
    rng.shuffle(order);

    vector<int64_t> full_walk;
    vector<int64_t> parent((size_t)num_nodes, -2), scratch;
    for (int64_t oc : order) {
        auto& nodes = comps[(size_t)oc];
        if (nodes.size() == 1) {
            full_walk.push_back(nodes[0]);
            continue;
        }
        // component edges
        vector<int64_t> ceu, cev;
        for (size_t e = 0; e < eu.size(); ++e) {
            if (comp[(size_t)eu[e]] == oc) {
                ceu.push_back(eu[e]);
                cev.push_back(ev[e]);
            }
        }
        int64_t base_edges = (int64_t)ceu.size();
        // odd-degree nodes
        vector<int64_t> deg_odd;
        for (int64_t node : nodes) {
            int64_t deg = adj.indptr[(size_t)node + 1] - adj.indptr[(size_t)node];
            if (deg % 2 == 1) deg_odd.push_back(node);
        }
        rng.shuffle(deg_odd);
        if (!deg_odd.empty()) {
            if (deg_odd.size() <= 14) {
                // exact matching on BFS distances
                size_t k = deg_odd.size();
                vector<vector<int64_t>> trees(k);
                vector<vector<double>> dist(k, vector<double>(k, 0.0));
                for (size_t a = 0; a < k; ++a) {
                    std::fill(parent.begin(), parent.end(), -2);
                    bfs_tree(adj, deg_odd[a], parent, scratch);
                    trees[a] = parent;
                }
                for (size_t a = 0; a < k; ++a) {
                    for (size_t b = a + 1; b < k; ++b) {
                        int64_t d = 0, node = deg_odd[b];
                        while (node != deg_odd[a]) {
                            node = trees[a][(size_t)node];
                            ++d;
                        }
                        dist[a][b] = dist[b][a] = (double)d;
                    }
                }
                vector<std::pair<int, int>> pairs;
                min_weight_pairs(dist, pairs);
                for (auto [a, b] : pairs) {
                    int64_t node = deg_odd[(size_t)b];
                    while (node != deg_odd[(size_t)a]) {
                        int64_t par = trees[(size_t)a][(size_t)node];
                        ceu.push_back(node);
                        cev.push_back(par);
                        node = par;
                    }
                }
            } else {
                // greedy nearest pairing
                vector<char> taken(deg_odd.size(), 0);
                for (size_t a = 0; a < deg_odd.size(); ++a) {
                    if (taken[a]) continue;
                    taken[a] = 1;
                    std::fill(parent.begin(), parent.end(), -2);
                    bfs_tree(adj, deg_odd[a], parent, scratch);
                    // nearest untaken odd node by BFS order
                    int64_t pick = -1;
                    for (int64_t node : scratch) {
                        for (size_t b = 0; b < deg_odd.size(); ++b) {
                            if (!taken[b] && deg_odd[b] == node) {
                                pick = (int64_t)b;
                                break;
                            }
                        }
                        if (pick >= 0) break;
                    }
                    taken[(size_t)pick] = 1;
                    int64_t node = deg_odd[(size_t)pick];
                    while (node != deg_odd[a]) {
                        int64_t par = parent[(size_t)node];
                        ceu.push_back(node);
                        cev.push_back(par);
                        node = par;
                    }
                }
            }
        }
        int64_t start = nodes[(size_t)rng.below((int64_t)nodes.size())];
        vector<int64_t> walk;
        hierholzer(num_nodes, ceu, cev, start, rng, walk);
        // shorten: truncate once all base (unique) edges are covered
        if (base_edges > 0) {
            vector<uint64_t> seen;
            seen.reserve(walk.size());
            int64_t covered = 0, cut = (int64_t)walk.size();
            // use a hash set via sorted insertion on small sizes
            std::vector<uint64_t> set;
            for (size_t i = 0; i + 1 < walk.size(); ++i) {
                int64_t a = walk[i], b = walk[i + 1];
                int64_t lo = a < b ? a : b, hi = a < b ? b : a;
                uint64_t key = (uint64_t)lo * (uint64_t)num_nodes + (uint64_t)hi;
                auto it = std::lower_bound(set.begin(), set.end(), key);
                if (it == set.end() || *it != key) {
                    set.insert(it, key);
                    ++covered;
                    if (covered == base_edges) {
                        cut = (int64_t)i + 2;
                        break;
                    }
                }
            }
            walk.resize((size_t)cut);
        }
        full_walk.insert(full_walk.end(), walk.begin(), walk.end());
    }
    std::memcpy(walk_out, full_walk.data(), full_walk.size() * sizeof(int64_t));
    return (int64_t)full_walk.size();
}

// Ego-k-hop node sampling over CSR (see sampling.ego_k_hop).
// nodes_out capacity must be >= a caller-chosen cap; returns count or -1 if
// the cap would be exceeded.
int64_t ggt_ego_k_hop(const int64_t* indptr, const int64_t* indices,
                      const int64_t* seeds, int64_t num_seeds, int64_t depth,
                      int64_t fanout, int64_t replace, uint64_t seed,
                      int64_t* nodes_out, int64_t cap) {
    Rng rng(seed);
    vector<int64_t> visited;
    vector<char> in_set;
    // discover max node id lazily: caller guarantees indptr covers all nodes
    vector<int64_t> frontier(seeds, seeds + num_seeds);
    visited = frontier;
    std::sort(visited.begin(), visited.end());
    vector<int64_t> nbrs;
    for (int64_t d = 0; d < depth; ++d) {
        vector<int64_t> nxt;
        for (int64_t node : frontier) {
            int64_t lo = indptr[node], hi = indptr[node + 1];
            int64_t deg = hi - lo;
            if (deg == 0) continue;
            nbrs.clear();
            if (fanout >= 0 && deg > fanout) {
                if (replace) {
                    for (int64_t t = 0; t < fanout; ++t)
                        nbrs.push_back(indices[lo + rng.below(deg)]);
                } else {
                    // partial Fisher-Yates over neighbor positions
                    vector<int64_t> pos((size_t)deg);
                    for (int64_t t = 0; t < deg; ++t) pos[(size_t)t] = t;
                    for (int64_t t = 0; t < fanout; ++t) {
                        int64_t j = t + rng.below(deg - t);
                        std::swap(pos[(size_t)t], pos[(size_t)j]);
                        nbrs.push_back(indices[lo + pos[(size_t)t]]);
                    }
                }
            } else {
                for (int64_t p = lo; p < hi; ++p) nbrs.push_back(indices[p]);
            }
            for (int64_t nb : nbrs) {
                auto it = std::lower_bound(visited.begin(), visited.end(), nb);
                if (it == visited.end() || *it != nb) {
                    visited.insert(it, nb);
                    nxt.push_back(nb);
                    if ((int64_t)visited.size() > cap) return -1;
                }
            }
        }
        frontier = std::move(nxt);
    }
    std::memcpy(nodes_out, visited.data(), visited.size() * sizeof(int64_t));
    return (int64_t)visited.size();
}

}  // extern "C"
