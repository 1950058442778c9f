// Native macro-property kernels for rollout scoring.
//
// C++ implementations of the macro counting semantics of
// the reference's datasets/nbody/visualization_utils.py:1093-1610 (sticking/
// collision run-lengths, leaving-area trailing streaks, sharp velocity
// turns, max CoM drift, pair-meets-triplet group collisions).  These run on
// the host during checkpoint evaluation; the group-collision interval logic
// in particular is O(sims * C(N,2) * C(N,3) * T) and benefits from native
// code at rollout scale (64 sims x 1000 steps).
//
// Exposed with a plain C ABI consumed via ctypes (metrics/native.py); the
// NumPy implementations in metrics/macros.py remain the portable reference
// and the test oracle.
//
// Build: python -m <pkg>.native.build   (g++ -O3 -shared -fPIC into <pkg>/_build/)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

inline double dist3(const double* a, const double* b) {
  const double dx = a[0] - b[0];
  const double dy = a[1] - b[1];
  const double dz = a[2] - b[2];
  return std::sqrt(dx * dx + dy * dy + dz * dz);
}

// loc layout: [S, T, N, 3] row-major doubles.
inline const double* at(const double* loc, int64_t T, int64_t N, int64_t s,
                        int64_t t, int64_t n) {
  return loc + ((s * T + t) * N + n) * 3;
}

struct Interval {
  int start;
  int end;  // inclusive; -1 while open
};

// Stuck intervals of a boolean contact series (threshold = consecutive
// steps); mirrors visualization_utils.py:1510-1571.
void runs_from_bool(const std::vector<uint8_t>& c, int time_thr,
                    std::vector<Interval>* out) {
  out->clear();
  int run = 0, start = 0;
  const int T = static_cast<int>(c.size());
  for (int t = 0; t < T; ++t) {
    if (c[t]) {
      ++run;
      if (run == time_thr) start = t - time_thr + 1;
    } else {
      if (run >= time_thr) out->push_back({start, t - 1});
      run = 0;
    }
  }
  if (run >= time_thr) out->push_back({start, T - 1});
}

}  // namespace

extern "C" {

// sticking/collision counts (visualization_utils.py:1093-1124): runs of
// contact within steps 1..T-1; stickings = runs >= time_thr, collisions =
// total runs - stickings.
void count_stickings_collisions(const double* loc, int64_t S, int64_t T,
                                int64_t N, int time_thr, double dist_thr,
                                double* stick_out, double* coll_out) {
  for (int64_t s = 0; s < S; ++s) {
    double stick = 0, coll = 0;
    for (int64_t i = 0; i < N; ++i) {
      for (int64_t j = i + 1; j < N; ++j) {
        int run = 0;
        for (int64_t t = 1; t < T; ++t) {
          const bool contact =
              dist3(at(loc, T, N, s, t, i), at(loc, T, N, s, t, j)) <= dist_thr;
          if (contact) {
            ++run;
            if (run == 1) coll += 1;
            if (run == time_thr) {
              stick += 1;
              coll -= 1;
            }
          } else {
            run = 0;
          }
        }
      }
    }
    stick_out[s] = stick;
    coll_out[s] = coll;
  }
}

// bodies whose trailing outside-CoM streak exceeds 10 steps
// (visualization_utils.py:1145-1167).
void count_leaving(const double* loc, int64_t S, int64_t T, int64_t N,
                   double dist_thr, double* out) {
  for (int64_t s = 0; s < S; ++s) {
    std::vector<double> streak(N, 0.0);
    for (int64_t t = 1; t < T; ++t) {
      double com[3] = {0, 0, 0};
      for (int64_t n = 0; n < N; ++n) {
        const double* p = at(loc, T, N, s, t, n);
        com[0] += p[0];
        com[1] += p[1];
        com[2] += p[2];
      }
      com[0] /= N;
      com[1] /= N;
      com[2] /= N;
      for (int64_t n = 0; n < N; ++n) {
        if (dist3(at(loc, T, N, s, t, n), com) > dist_thr)
          streak[n] += 1;
        else
          streak[n] = 0;
      }
    }
    double count = 0;
    for (int64_t n = 0; n < N; ++n)
      if (streak[n] > 10) count += 1;
    out[s] = count;
  }
}

// max distance of the CoM from its starting position
// (visualization_utils.py:1170-1187).
void max_com_distance(const double* loc, int64_t S, int64_t T, int64_t N,
                      double* out) {
  for (int64_t s = 0; s < S; ++s) {
    double com0[3] = {0, 0, 0};
    for (int64_t n = 0; n < N; ++n) {
      const double* p = at(loc, T, N, s, 0, n);
      com0[0] += p[0];
      com0[1] += p[1];
      com0[2] += p[2];
    }
    com0[0] /= N;
    com0[1] /= N;
    com0[2] /= N;
    double best = 0;
    bool has_nan = false;
    for (int64_t t = 1; t < T; ++t) {
      double com[3] = {0, 0, 0};
      for (int64_t n = 0; n < N; ++n) {
        const double* p = at(loc, T, N, s, t, n);
        com[0] += p[0];
        com[1] += p[1];
        com[2] += p[2];
      }
      com[0] /= N;
      com[1] /= N;
      com[2] /= N;
      const double d = dist3(com0, com);
      // np.max propagates NaN: a diverged rollout's NaN frames must yield
      // NaN here too, or native and NumPy backends score different
      // com_movement distributions
      if (std::isnan(d)) has_nan = true;
      if (d > best) best = d;
    }
    out[s] = has_nan ? std::numeric_limits<double>::quiet_NaN() : best;
  }
}

// velocity-direction changes sharper than angle_thr degrees
// (visualization_utils.py:1190-1222); zero-speed frames produce NaN angles
// which compare false, matching NumPy.
void count_sharp_turns(const double* vel, int64_t S, int64_t T, int64_t N,
                       double angle_thr_deg, double* out) {
  const double kRad2Deg = 180.0 / M_PI;
  for (int64_t s = 0; s < S; ++s) {
    double count = 0;
    for (int64_t t = 1; t < T; ++t) {
      for (int64_t n = 0; n < N; ++n) {
        const double* a = at(vel, T, N, s, t, n);
        const double* b = at(vel, T, N, s, t - 1, n);
        const double na = std::sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
        const double nb = std::sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
        const double denom = na * nb;
        if (denom == 0.0) continue;  // NaN angle in NumPy -> comparison false
        double cosv = (a[0] * b[0] + a[1] * b[1] + a[2] * b[2]) / denom;
        if (cosv > 1.0) cosv = 1.0;
        if (cosv < -1.0) cosv = -1.0;
        if (std::acos(cosv) * kRad2Deg > angle_thr_deg) count += 1;
      }
    }
    out[s] = count;
  }
}

// pair-meets-triplet group collisions (visualization_utils.py:1455-1610).
void count_group_collisions(const double* loc, int64_t S, int64_t T, int64_t N,
                            int time_thr, double dist_thr, double* out) {
  const int64_t P = N * (N - 1) / 2;
  std::vector<int> pi(P), pj(P);
  {
    int64_t k = 0;
    for (int i = 0; i < N; ++i)
      for (int j = i + 1; j < N; ++j) {
        pi[k] = i;
        pj[k] = j;
        ++k;
      }
  }
  auto pidx = [&](int a, int b) {
    if (a > b) std::swap(a, b);
    // index of pair (a, b) in lexicographic i<j order
    return a * (2 * N - a - 1) / 2 + (b - a - 1);
  };

  std::vector<uint8_t> contact(P * T);
  std::vector<Interval> ivbuf;
  for (int64_t s = 0; s < S; ++s) {
    for (int64_t k = 0; k < P; ++k)
      for (int64_t t = 0; t < T; ++t)
        contact[k * T + t] =
            dist3(at(loc, T, N, s, t, pi[k]), at(loc, T, N, s, t, pj[k])) <=
            dist_thr;

    // stuck pairs
    std::vector<std::vector<Interval>> stuck_pairs(P);
    std::vector<uint8_t> series(T);
    for (int64_t k = 0; k < P; ++k) {
      std::memcpy(series.data(), contact.data() + k * T, T);
      runs_from_bool(series, time_thr, &ivbuf);
      stuck_pairs[k] = ivbuf;
    }

    // stuck triplets
    struct Trip {
      int i, j, k;
      std::vector<Interval> ivs;
    };
    std::vector<Trip> trips;
    for (int i = 0; i < N; ++i)
      for (int j = i + 1; j < N; ++j)
        for (int k = j + 1; k < N; ++k) {
          const int64_t a = pidx(i, j), b = pidx(i, k), c = pidx(j, k);
          for (int64_t t = 0; t < T; ++t)
            series[t] = contact[a * T + t] && contact[b * T + t] &&
                        contact[c * T + t];
          runs_from_bool(series, time_thr, &ivbuf);
          if (!ivbuf.empty()) trips.push_back({i, j, k, ivbuf});
        }

    // Last contact step per pair (-1 when never in contact).  The original
    // inner test was "any cross-pair contact at any step >= o_start", i.e.
    // an O(T) cross/suffix scan per (pair, triplet) combination — at N=100
    // with contact-dense gravity data (most of C(N,2) x C(N,3) combinations
    // alive) that scan made the kernel minutes-per-sim.  The test is
    // exactly equivalent to max(last_contact[q] for the 6 cross pairs q)
    // >= o_start, which is O(1) per combination after this O(P*T) pass.
    std::vector<int> last_contact(P, -1);
    for (int64_t k = 0; k < P; ++k)
      for (int64_t t = T - 1; t >= 0; --t)
        if (contact[k * T + t]) {
          last_contact[k] = static_cast<int>(t);
          break;
        }

    double group = 0;
    for (int64_t k = 0; k < P; ++k) {
      if (stuck_pairs[k].empty()) continue;
      const int a0 = pi[k], a1 = pj[k];
      for (const auto& tr : trips) {
        if (a0 == tr.i || a0 == tr.j || a0 == tr.k || a1 == tr.i ||
            a1 == tr.j || a1 == tr.k)
          continue;  // must be disjoint
        // latest step with any pair-body/triplet-body cross contact
        const int tb[3] = {tr.i, tr.j, tr.k};
        int max_last = -1;
        for (int pb : {a0, a1})
          for (int q = 0; q < 3; ++q) {
            const int lc = last_contact[pidx(pb, tb[q])];
            if (lc > max_last) max_last = lc;
          }
        if (max_last < 0) continue;
        for (const auto& pv : stuck_pairs[k]) {
          for (const auto& tv : tr.ivs) {
            const int o_start = pv.start > tv.start ? pv.start : tv.start;
            const int o_end = pv.end < tv.end ? pv.end : tv.end;
            if (o_start <= o_end && o_start <= max_last) group += 1;
          }
        }
      }
    }
    out[s] = group;
  }
}

// Per-sim time-mean size of the largest stuck cluster (first-party large-N
// macro, no reference analogue; NumPy oracle: metrics/macros.py
// stuck_cluster_sizes).  Stuck-pair primitive matches the group macro's
// (contact <= dist_thr; pair stuck at t iff its contact run containing t
// lasts >= time_thr steps); per step, union-find over stuck pairs gives
// connected components; the step statistic is the largest component size
// (0 when no pair is stuck) and the sim statistic is its mean over T.
void stuck_cluster_sizes(const double* loc, int64_t S, int64_t T, int64_t N,
                         int time_thr, double dist_thr, double* out) {
  const int64_t P = N * (N - 1) / 2;
  std::vector<int> pi(P), pj(P);
  {
    int64_t k = 0;
    for (int i = 0; i < N; ++i)
      for (int j = i + 1; j < N; ++j) {
        pi[k] = i;
        pj[k] = j;
        ++k;
      }
  }
  std::vector<uint8_t> contact(P * T), stuck(P * T);
  std::vector<int> parent(N), size(N);
  auto find = [&parent](int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t s = 0; s < S; ++s) {
    for (int64_t k = 0; k < P; ++k)
      for (int64_t t = 0; t < T; ++t)
        contact[k * T + t] =
            dist3(at(loc, T, N, s, t, pi[k]), at(loc, T, N, s, t, pj[k])) <=
            dist_thr;
    // stuck[t] = run containing t has total length >= time_thr
    for (int64_t k = 0; k < P; ++k) {
      const uint8_t* c = contact.data() + k * T;
      uint8_t* st = stuck.data() + k * T;
      int64_t t = 0;
      while (t < T) {
        if (!c[t]) {
          st[t] = 0;
          ++t;
          continue;
        }
        int64_t e = t;
        while (e + 1 < T && c[e + 1]) ++e;
        const uint8_t v = (e - t + 1) >= time_thr;
        for (int64_t q = t; q <= e; ++q) st[q] = v;
        t = e + 1;
      }
    }
    double acc = 0;
    for (int64_t t = 0; t < T; ++t) {
      for (int64_t n = 0; n < N; ++n) {
        parent[n] = static_cast<int>(n);
        size[n] = 1;
      }
      bool any = false;
      for (int64_t k = 0; k < P; ++k) {
        if (!stuck[k * T + t]) continue;
        any = true;
        int a = find(pi[k]), b = find(pj[k]);
        if (a != b) {
          if (size[a] < size[b]) std::swap(a, b);
          parent[b] = a;
          size[a] += size[b];
        }
      }
      if (any) {
        int best = 0;
        for (int64_t n = 0; n < N; ++n)
          if (parent[n] == n && size[n] > best) best = size[n];
        if (best >= 2) acc += best;
      }
    }
    out[s] = acc / static_cast<double>(T);
  }
}

}  // extern "C"
