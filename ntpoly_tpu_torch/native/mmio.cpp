// Matrix Market coordinate parse and format for ntpoly_tpu_torch.
//
// A copy of ntpoly_tpu/native/mmio.cpp (the JAX package's native host
// runtime), kept here so that the port needs nothing of that package.
// The body of a file is split into per-thread byte ranges aligned to
// line boundaries (the reference's per-rank MPI-IO ranges with their
// line-boundary fix-up, Source/Fortran/PSMatrixModule.F90:351-570),
// each thread parses its range with a branch-light scanner, and the
// results are stitched by prefix-summed counts.  Exposed through ctypes
// (extern "C"), no Python-object traffic.
//
// Build: ntpoly_tpu_torch/native/__init__.py (g++ -O3 -march=native
// -std=c++17 -shared -fPIC -pthread), at first use.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Fast float parse: strtod is locale-aware and slow; MM files are plain
// "%g"-style numbers, so a hand-rolled scanner wins ~4x.
inline double parse_double(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  double mant = 0.0;
  while (p < end && *p >= '0' && *p <= '9') mant = mant * 10.0 + (*p++ - '0');
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      mant += (*p++ - '0') * scale;
      scale *= 0.1;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    int ex = 0;
    while (p < end && *p >= '0' && *p <= '9') ex = ex * 10 + (*p++ - '0');
    mant *= std::pow(10.0, eneg ? -ex : ex);
  }
  return neg ? -mant : mant;
}

inline int64_t parse_int(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return neg ? -v : v;
}

inline void skip_line(const char*& p, const char* end) {
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;
}

// field codes (must match ntpoly_tpu_torch/native/__init__.py)
enum Field { kReal = 0, kComplex = 1, kPattern = 2, kInteger = 3 };

struct Range {
  const char* begin;
  const char* end;
};

// Split [buf, buf+len) into n line-aligned ranges (reference's
// line-boundary fix-up, PSMatrixModule.F90:495-513).
std::vector<Range> split_ranges(const char* buf, int64_t len, int n) {
  std::vector<Range> out;
  const char* end = buf + len;
  const char* cur = buf;
  for (int t = 0; t < n; ++t) {
    const char* stop = buf + len * (t + 1) / n;
    if (stop < end) {
      while (stop < end && *stop != '\n') ++stop;
      if (stop < end) ++stop;
    }
    if (t == n - 1) stop = end;
    out.push_back({cur, stop});
    cur = stop;
    if (cur >= end) {
      for (int r = t + 1; r < n; ++r) out.push_back({end, end});
      break;
    }
  }
  return out;
}

int64_t count_entries(const Range& r) {
  int64_t n = 0;
  const char* p = r.begin;
  while (p < r.end) {
    while (p < r.end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= r.end) break;
    if (*p == '%') {
      skip_line(p, r.end);
      continue;
    }
    ++n;
    skip_line(p, r.end);
  }
  return n;
}

void parse_range(const Range& r, int field, int64_t* ri, int64_t* ci,
                 double* vre, double* vim) {
  const char* p = r.begin;
  int64_t n = 0;
  while (p < r.end) {
    while (p < r.end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= r.end) break;
    if (*p == '%') {
      skip_line(p, r.end);
      continue;
    }
    ri[n] = parse_int(p, r.end) - 1;
    ci[n] = parse_int(p, r.end) - 1;
    switch (field) {
      case kPattern:
        vre[n] = 1.0;
        break;
      case kComplex:
        vre[n] = parse_double(p, r.end);
        vim[n] = parse_double(p, r.end);
        break;
      default:
        vre[n] = parse_double(p, r.end);
        break;
    }
    ++n;
    skip_line(p, r.end);
  }
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// %.16g formatting without snprintf's overhead is not worth the risk;
// snprintf into a thread-local chunk is already ~10x the Python loop.
void format_range(int64_t lo, int64_t hi, const int64_t* ri, const int64_t* ci,
                  const double* vre, const double* vim, int field,
                  std::string* out) {
  char line[128];
  out->reserve((hi - lo) * 48);
  for (int64_t n = lo; n < hi; ++n) {
    int len;
    if (field == kComplex) {
      len = snprintf(line, sizeof line, "%lld %lld %.16g %.16g\n",
                     static_cast<long long>(ri[n] + 1),
                     static_cast<long long>(ci[n] + 1), vre[n], vim[n]);
    } else {
      len = snprintf(line, sizeof line, "%lld %lld %.16g\n",
                     static_cast<long long>(ri[n] + 1),
                     static_cast<long long>(ci[n] + 1), vre[n]);
    }
    out->append(line, len);
  }
}

}  // namespace

extern "C" {

// Pass 1: count data entries in the body (comments skipped).  ``buf`` is the
// file body after the header line; the first non-comment line is the size
// line and is counted too — the caller subtracts it.
int64_t ntx_mm_count(const char* buf, int64_t len) {
  int nt = hw_threads();
  auto ranges = split_ranges(buf, len, nt);
  std::vector<int64_t> counts(nt, 0);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t)
    ts.emplace_back([&, t] { counts[t] = count_entries(ranges[t]); });
  for (auto& th : ts) th.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Pass 2: parse ``n_entries`` (i, j, v) records into caller-allocated
// arrays.  Entry 0 is the size line parsed as integers — the caller strips
// it (keeps the scanner branch-free).  Returns entries written.
int64_t ntx_mm_parse(const char* buf, int64_t len, int field, int64_t* ri,
                     int64_t* ci, double* vre, double* vim) {
  int nt = hw_threads();
  auto ranges = split_ranges(buf, len, nt);
  std::vector<int64_t> counts(nt, 0);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, t] { counts[t] = count_entries(ranges[t]); });
    for (auto& th : ts) th.join();
  }
  std::vector<int64_t> offs(nt + 1, 0);
  for (int t = 0; t < nt; ++t) offs[t + 1] = offs[t] + counts[t];
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, t] {
        parse_range(ranges[t], field, ri + offs[t], ci + offs[t],
                    vre + offs[t], vim ? vim + offs[t] : nullptr);
      });
    for (auto& th : ts) th.join();
  }
  return offs[nt];
}

// Format triplets as MM coordinate lines (1-based); writes through a
// callback-free two-pass contract: call with out=nullptr to get the byte
// count, then with a buffer of at least that size.
int64_t ntx_mm_format(const int64_t* ri, const int64_t* ci, const double* vre,
                      const double* vim, int64_t n, int field, char* out,
                      int64_t out_cap) {
  int nt = hw_threads();
  if (n < 4096) nt = 1;
  std::vector<std::string> chunks(nt);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    ts.emplace_back(
        [&, t, lo, hi] { format_range(lo, hi, ri, ci, vre, vim, field,
                                      &chunks[t]); });
  }
  for (auto& th : ts) th.join();
  int64_t total = 0;
  for (auto& c : chunks) total += static_cast<int64_t>(c.size());
  if (out == nullptr) return total;
  if (total > out_cap) return -1;
  char* p = out;
  for (auto& c : chunks) {
    std::memcpy(p, c.data(), c.size());
    p += c.size();
  }
  return total;
}

}  // extern "C"
