// Fill-reducing orderings + maximum-product matching (native runtime).
//
// The reference links METIS / AMD / RCM orderings and the MC64 Fortran
// matching into ILUPACK (pcildl.c:147-193, Makefile:32-37). TPU-native
// equivalents, from scratch:
//
//   amd_order  -- Approximate Minimum Degree (Amestoy-Davis-Duff):
//                 quotient-graph elimination with element absorption,
//                 approximate external degrees (|Le \ Lp| one-pass w-array
//                 computation) and hash-based supervariable coalescing.
//   nd_order   -- nested dissection ("metisn" class): recursive level-set
//                 bisection with pseudo-peripheral roots; separators are
//                 ordered last, small leaves by minimum degree (AMD).
//   mc64_scale -- maximum-product bipartite matching via shortest
//                 augmenting paths with dual potentials (the JV
//                 algorithm on costs log(colmax/|a|)); returns the MC64
//                 row/column scalings exp(u_i), exp(v_j - log colmax_j)
//                 that make every matched entry 1 and all others <= 1.
//
// Graphs arrive as full symmetric CSR (int64 indptr/indices); self-loops
// are ignored.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <algorithm>

using std::int64_t;
typedef int64_t i64;

extern "C" {

// --------------------------------------------------------------------------
// AMD
// --------------------------------------------------------------------------

// status codes
static const int VAR = 0, ELEM = 1, DEAD = 2;

int amd_order(i64 n, const i64 *Ap, const i64 *Aj, i64 *perm)
{
    if (n == 0) return 0;
    // adjacency: per live variable, separate lists of variable- and
    // element-neighbours; per element, its variable list
    std::vector<std::vector<i64>> adjv(n), adje(n), evars(n);
    std::vector<int> stat(n, VAR);
    std::vector<i64> deg(n), nv(n, 1);       // nv: supervariable size
    std::vector<i64> w(n, -1), hash(n, 0);
    std::vector<char> in_lp(n, 0);

    for (i64 i = 0; i < n; i++) {
        for (i64 p = Ap[i]; p < Ap[i + 1]; p++)
            if (Aj[p] != i) adjv[i].push_back(Aj[p]);
        deg[i] = (i64)adjv[i].size();
    }

    // bucket structure for min-degree selection
    std::vector<std::vector<i64>> bucket(n + 1);
    std::vector<i64> bpos(n, 0);
    for (i64 i = 0; i < n; i++) {
        bucket[deg[i]].push_back(i);
        bpos[i] = (i64)bucket[deg[i]].size() - 1;
    }
    auto bucket_move = [&](i64 i, i64 newdeg) {
        // lazy removal: mark old slot invalid by swap-pop if cheap
        std::vector<i64> &b = bucket[deg[i]];
        if (bpos[i] < (i64)b.size() && b[bpos[i]] == i) {
            b[bpos[i]] = b.back();
            if (bpos[i] < (i64)b.size() - 1) bpos[b[bpos[i]]] = bpos[i];
            b.pop_back();
        }
        deg[i] = newdeg < 0 ? 0 : (newdeg > n ? n : newdeg);
        bucket[deg[i]].push_back(i);
        bpos[i] = (i64)bucket[deg[i]].size() - 1;
    };

    i64 k = 0;        // number of original indices eliminated
    i64 mindeg = 0;
    std::vector<i64> Lp_list, order;
    order.reserve(n);
    std::vector<i64> elim_order;    // supervariable heads in elim order

    while (k < n) {
        // pick min-degree live variable
        i64 p = -1;
        while (mindeg <= n) {
            std::vector<i64> &b = bucket[mindeg];
            while (!b.empty()) {
                i64 c = b.back();
                if (stat[c] == VAR && deg[c] == mindeg) { p = c; break; }
                b.pop_back();
            }
            if (p >= 0) break;
            mindeg++;
        }
        if (p < 0) break;           // defensive
        // remove p from its bucket
        {
            std::vector<i64> &b = bucket[mindeg];
            b.pop_back();
        }

        // --- form element p: Lp = adjv(p) + U vars(e in adje(p)) \ {p} ---
        Lp_list.clear();
        for (i64 v : adjv[p])
            if (stat[v] == VAR && !in_lp[v]) {
                in_lp[v] = 1; Lp_list.push_back(v);
            }
        for (i64 e : adje[p]) {
            if (stat[e] != ELEM) continue;
            for (i64 v : evars[e])
                if (stat[v] == VAR && v != p && !in_lp[v]) {
                    in_lp[v] = 1; Lp_list.push_back(v);
                }
            stat[e] = DEAD;         // absorbed into p
            evars[e].clear(); evars[e].shrink_to_fit();
        }
        adjv[p].clear(); adjv[p].shrink_to_fit();
        adje[p].clear(); adje[p].shrink_to_fit();
        stat[p] = ELEM;
        evars[p] = Lp_list;
        elim_order.push_back(p);
        k += nv[p];
        i64 lp_weight = 0;
        for (i64 v : Lp_list) lp_weight += nv[v];

        // --- one-pass |Le \ Lp| (w-array): for each element e adjacent
        // to some i in Lp, w[e] = |Le| - |Le ^ Lp| after the scan ---
        for (i64 i : Lp_list)
            for (i64 e : adje[i]) {
                if (stat[e] != ELEM) continue;
                if (w[e] < 0) {
                    i64 sz = 0;
                    for (i64 v : evars[e])
                        if (stat[v] == VAR) sz += nv[v];
                    w[e] = sz;
                }
                w[e] -= nv[i];
            }

        // --- update each i in Lp ---
        for (i64 i : Lp_list) {
            // prune dead elements; aggressive absorption (Le subset Lp)
            std::vector<i64> &ei = adje[i];
            i64 m = 0;
            for (i64 e : ei) {
                if (stat[e] != ELEM) continue;
                if (w[e] == 0) {    // Le \ Lp empty: absorb e into p
                    stat[e] = DEAD;
                    evars[e].clear(); evars[e].shrink_to_fit();
                    continue;
                }
                ei[m++] = e;
            }
            ei.resize(m);
            ei.push_back(p);
            // prune variable list: drop dead/eliminated and members of Lp
            // (their coupling is now through element p)
            std::vector<i64> &vi = adjv[i];
            m = 0;
            i64 avdeg = 0;
            for (i64 v : vi) {
                if (stat[v] != VAR || in_lp[v]) continue;
                vi[m++] = v;
                avdeg += nv[v];
            }
            vi.resize(m);
            // approximate external degree
            i64 d = avdeg + (lp_weight - nv[i]);
            for (i64 e : ei)
                if (e != p && stat[e] == ELEM && w[e] >= 0)
                    d += w[e];
            i64 dmax = n - k;
            if (d > dmax) d = dmax;
            if (deg[i] + (lp_weight - nv[i]) < d)
                d = deg[i] + (lp_weight - nv[i]);
            bucket_move(i, d);
            if (d < mindeg) mindeg = d;
            // hash for supervariable detection
            i64 h = 0;
            for (i64 v : vi) h += v;
            for (i64 e : ei) h += e;
            hash[i] = ((h % n) + n) % n;
        }

        // --- supervariable coalescing within Lp (same hash, identical
        // adjacency): sort by hash so only equal-hash runs are compared ---
        std::vector<i64> lp_sorted = Lp_list;
        std::sort(lp_sorted.begin(), lp_sorted.end(),
                  [&](i64 a, i64 b) { return hash[a] < hash[b]; });
        for (size_t a = 0; a < lp_sorted.size(); a++) {
            i64 i = lp_sorted[a];
            if (stat[i] != VAR) continue;
            for (size_t b = a + 1; b < lp_sorted.size()
                     && hash[lp_sorted[b]] == hash[i]; b++) {
                i64 j = lp_sorted[b];
                if (stat[j] != VAR) continue;
                // compare adjacency sets (both pruned above; sort copies)
                if (adjv[i].size() != adjv[j].size()
                    || adje[i].size() != adje[j].size()) continue;
                std::vector<i64> vi = adjv[i], vj = adjv[j];
                std::sort(vi.begin(), vi.end());
                std::sort(vj.begin(), vj.end());
                // i and j reference each other through elements only after
                // pruning, but variable lists may still cross-reference
                vi.erase(std::remove(vi.begin(), vi.end(), j), vi.end());
                vj.erase(std::remove(vj.begin(), vj.end(), i), vj.end());
                if (vi != vj) continue;
                std::vector<i64> ei = adje[i], ej = adje[j];
                std::sort(ei.begin(), ei.end());
                std::sort(ej.begin(), ej.end());
                if (ei != ej) continue;
                // absorb j into i
                nv[i] += nv[j];
                nv[j] = 0;
                stat[j] = DEAD;
                adjv[j].clear(); adjv[j].shrink_to_fit();
                adje[j].clear(); adje[j].shrink_to_fit();
                // j's eliminated indices ride with i (record via chain)
                // store chain: reuse hash[j] slot as "absorbed into"
                hash[j] = -(i + 1);
            }
        }

        // reset w and in_lp (every live element with w set is adjacent to
        // some i in Lp, so this covers them; stale w on dead elements is
        // never read)
        for (i64 i : Lp_list) {
            in_lp[i] = 0;
            for (i64 e : adje[i]) w[e] = -1;
        }
    }

    // --- emit permutation: elements in elimination order, each head
    // followed by the supervariables absorbed into it (chains) ---
    std::vector<std::vector<i64>> members(n);
    for (i64 j = 0; j < n; j++)
        if (hash[j] < 0 && stat[j] == DEAD && nv[j] == 0) {
            i64 h2 = -(hash[j] + 1);
            // follow the chain to a live head or an eliminated element
            while (hash[h2] < 0 && stat[h2] == DEAD && nv[h2] == 0)
                h2 = -(hash[h2] + 1);
            members[h2].push_back(j);
        }
    i64 pos = 0;
    std::vector<char> placed(n, 0);
    for (i64 e : elim_order) {
        if (placed[e]) continue;
        perm[pos++] = e; placed[e] = 1;
        for (i64 mbr : members[e])
            if (!placed[mbr]) { perm[pos++] = mbr; placed[mbr] = 1; }
    }
    for (i64 i = 0; i < n && pos < n; i++)
        if (!placed[i]) { perm[pos++] = i; placed[i] = 1; }
    return pos == n ? 0 : 1;
}

// --------------------------------------------------------------------------
// nested dissection
// --------------------------------------------------------------------------

static i64 nd_bfs(const i64 *Ap, const i64 *Aj, const std::vector<i64> &nodes,
                  const std::vector<i64> &local, std::vector<i64> &level,
                  i64 root, std::vector<i64> &q)
{
    // BFS over the subgraph induced by `nodes` (local[g] = local index or
    // -1). Returns number of levels; fills level[] (local indexing).
    std::fill(level.begin(), level.end(), (i64)-1);
    q.clear();
    q.push_back(root);
    level[root] = 0;
    i64 maxlev = 0;
    for (size_t h = 0; h < q.size(); h++) {
        i64 u = q[h];
        i64 g = nodes[u];
        for (i64 p = Ap[g]; p < Ap[g + 1]; p++) {
            i64 l = local[Aj[p]];
            if (l < 0 || level[l] >= 0) continue;
            level[l] = level[u] + 1;
            if (level[l] > maxlev) maxlev = level[l];
            q.push_back(l);
        }
    }
    return maxlev + 1;
}

static void nd_recurse(const i64 *Ap, const i64 *Aj,
                       std::vector<i64> nodes, i64 *perm, i64 &pos,
                       std::vector<i64> &local, i64 leaf)
{
    i64 m = (i64)nodes.size();
    if (m == 0) return;
    if (m <= leaf) {
        // leaf: minimum-degree order the block (AMD on the subgraph)
        std::vector<i64> sAp(m + 1, 0), sAj;
        for (i64 u = 0; u < m; u++) local[nodes[u]] = u;
        for (i64 u = 0; u < m; u++) {
            i64 g = nodes[u];
            for (i64 p = Ap[g]; p < Ap[g + 1]; p++)
                if (local[Aj[p]] >= 0 && Aj[p] != g) sAp[u + 1]++;
        }
        for (i64 u = 0; u < m; u++) sAp[u + 1] += sAp[u];
        sAj.resize(sAp[m]);
        std::vector<i64> fill = sAp;
        for (i64 u = 0; u < m; u++) {
            i64 g = nodes[u];
            for (i64 p = Ap[g]; p < Ap[g + 1]; p++) {
                i64 l = local[Aj[p]];
                if (l >= 0 && Aj[p] != g) sAj[fill[u]++] = l;
            }
        }
        std::vector<i64> sub(m);
        amd_order(m, sAp.data(), sAj.data(), sub.data());
        for (i64 u = 0; u < m; u++) perm[pos++] = nodes[sub[u]];
        for (i64 u = 0; u < m; u++) local[nodes[u]] = -1;
        return;
    }
    for (i64 u = 0; u < m; u++) local[nodes[u]] = u;
    std::vector<i64> level(m), q;
    // pseudo-peripheral root: start anywhere, BFS twice
    i64 root = 0;
    i64 nlev = nd_bfs(Ap, Aj, nodes, local, level, root, q);
    root = q.back();
    nlev = nd_bfs(Ap, Aj, nodes, local, level, root, q);
    if ((i64)q.size() < m) {
        // disconnected: recurse on the reached component and the rest
        std::vector<i64> comp, rest;
        std::vector<char> seen(m, 0);
        for (i64 u : q) seen[u] = 1;
        for (i64 u = 0; u < m; u++)
            (seen[u] ? comp : rest).push_back(nodes[u]);
        for (i64 u = 0; u < m; u++) local[nodes[u]] = -1;
        nd_recurse(Ap, Aj, comp, perm, pos, local, leaf);
        nd_recurse(Ap, Aj, rest, perm, pos, local, leaf);
        return;
    }
    if (nlev < 3) {
        // no room to bisect: minimum-degree the whole block
        for (i64 u = 0; u < m; u++) local[nodes[u]] = -1;
        nd_recurse(Ap, Aj, nodes, perm, pos, local, m);
        return;
    }
    i64 mid = nlev / 2;
    std::vector<i64> left, right, sep;
    for (i64 u = 0; u < m; u++) {
        if (level[u] < mid) left.push_back(nodes[u]);
        else if (level[u] > mid) right.push_back(nodes[u]);
        else sep.push_back(nodes[u]);
    }
    for (i64 u = 0; u < m; u++) local[nodes[u]] = -1;
    nd_recurse(Ap, Aj, left, perm, pos, local, leaf);
    nd_recurse(Ap, Aj, right, perm, pos, local, leaf);
    // separator last (ordered by minimum degree among itself)
    nd_recurse(Ap, Aj, sep, perm, pos, local, std::max<i64>(sep.size(), 1));
}

int nd_order(i64 n, const i64 *Ap, const i64 *Aj, i64 *perm, i64 leaf)
{
    std::vector<i64> nodes(n), local(n, -1);
    for (i64 i = 0; i < n; i++) nodes[i] = i;
    i64 pos = 0;
    if (leaf <= 0) leaf = 64;
    nd_recurse(Ap, Aj, nodes, perm, pos, local, leaf);
    return pos == n ? 0 : 1;
}

// --------------------------------------------------------------------------
// MC64: maximum-product matching + scalings
// --------------------------------------------------------------------------

int mc64_scale(i64 n, const i64 *Ap, const i64 *Aj, const double *Ax,
               double *sr, double *sc, i64 *match)
{
    // costs per CSR row i (bipartite: rows <-> columns of a structurally
    // symmetric matrix): c_ij = logmax_i - log|a_ij| >= 0
    const double INF = 1e300;
    std::vector<double> logmax(n, -INF), c(Ap[n]);
    for (i64 i = 0; i < n; i++)
        for (i64 p = Ap[i]; p < Ap[i + 1]; p++) {
            double la = std::log(std::fabs(Ax[p]) + 1e-300);
            if (la > logmax[i]) logmax[i] = la;
        }
    for (i64 i = 0; i < n; i++)
        for (i64 p = Ap[i]; p < Ap[i + 1]; p++)
            c[p] = logmax[i] - std::log(std::fabs(Ax[p]) + 1e-300);

    std::vector<double> u(n, 0.0), v(n, 0.0), dist(n);
    std::vector<i64> row_of(n, -1), col_of(n, -1), prev(n);
    std::vector<char> done(n);

    // greedy initial matching on zero reduced costs
    for (i64 i = 0; i < n; i++) {
        double cmin = INF;
        for (i64 p = Ap[i]; p < Ap[i + 1]; p++)
            if (c[p] < cmin) cmin = c[p];
        u[i] = cmin == INF ? 0.0 : cmin;
    }
    for (i64 j = 0; j < n; j++) v[j] = 0.0;
    // v_j = min_i (c_ij - u_i) over column j: build column lists on the fly
    {
        std::vector<double> vmin(n, INF);
        for (i64 i = 0; i < n; i++)
            for (i64 p = Ap[i]; p < Ap[i + 1]; p++) {
                double r = c[p] - u[i];
                if (r < vmin[Aj[p]]) vmin[Aj[p]] = r;
            }
        for (i64 j = 0; j < n; j++) v[j] = vmin[j] == INF ? 0.0 : vmin[j];
    }
    for (i64 i = 0; i < n; i++)
        for (i64 p = Ap[i]; p < Ap[i + 1] && col_of[i] < 0; p++) {
            i64 j = Aj[p];
            if (row_of[j] < 0 && c[p] - u[i] - v[j] < 1e-14) {
                row_of[j] = i; col_of[i] = j;
            }
        }

    // shortest augmenting path per unmatched row (Dijkstra, heap)
    typedef std::pair<double, i64> HN;
    for (i64 s = 0; s < n; s++) {
        if (col_of[s] >= 0) continue;
        std::fill(dist.begin(), dist.end(), INF);
        std::fill(done.begin(), done.end(), 0);
        std::priority_queue<HN, std::vector<HN>, std::greater<HN>> heap;
        // relax from row s
        for (i64 p = Ap[s]; p < Ap[s + 1]; p++) {
            i64 j = Aj[p];
            double d = c[p] - u[s] - v[j];
            if (d < dist[j]) {
                dist[j] = d; prev[j] = s;
                heap.push(HN(d, j));
            }
        }
        i64 endcol = -1;
        double lsap = INF;
        while (!heap.empty()) {
            HN top = heap.top(); heap.pop();
            i64 j = top.second;
            if (done[j] || top.first > dist[j] + 1e-18) continue;
            done[j] = 1;
            if (row_of[j] < 0) { endcol = j; lsap = dist[j]; break; }
            i64 i = row_of[j];
            for (i64 p = Ap[i]; p < Ap[i + 1]; p++) {
                i64 j2 = Aj[p];
                if (done[j2]) continue;
                double d = dist[j] + c[p] - u[i] - v[j2];
                if (d < dist[j2] - 1e-18) {
                    dist[j2] = d; prev[j2] = i;
                    heap.push(HN(d, j2));
                }
            }
        }
        if (endcol < 0) return 1;       // structurally singular
        // dual updates
        for (i64 j = 0; j < n; j++)
            if (done[j] && j != endcol) {
                v[j] += dist[j] - lsap;
                u[row_of[j]] -= dist[j] - lsap;
            }
        u[s] += lsap;
        // augment
        i64 j = endcol;
        while (true) {
            i64 i = prev[j];
            i64 jnext = col_of[i];
            row_of[j] = i; col_of[i] = j;
            if (i == s) break;
            j = jnext;
        }
    }

    // scalings: |a_ij| * exp(u_i - logmax_i) * exp(v_j) == 1 on matching
    for (i64 i = 0; i < n; i++) sr[i] = std::exp(u[i] - logmax[i]);
    for (i64 j = 0; j < n; j++) sc[j] = std::exp(v[j]);
    for (i64 j = 0; j < n; j++) match[j] = row_of[j];
    return 0;
}

void order_free(void *p) { free(p); }

}  // extern "C"
