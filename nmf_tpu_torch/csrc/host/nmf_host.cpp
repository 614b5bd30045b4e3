// nmf_host: the port's host runtime, on the CPU's cores.
//
// The data path that feeds the card: parsing a Matrix Market coordinate
// file, COO -> CSR with duplicates summed, and the mechanical array passes of
// the tiled store's binner (nmf_tpu_torch/ops/sparse_format.py).  The binning
// logic stays in Python; these functions replace only its loops over the
// nonzeros, each parallel and bounded by memory bandwidth.  Every function
// gives the bits of its numpy version in nmf_tpu_torch/io/loader.py
// (``_<name>_plain``).
//
// Plain C interface, reached through ctypes.  nmf_tpu_torch/io/native.py
// compiles this file at first use:
//   g++ -O3 -std=c++17 -fPIC -pthread -shared -o libnmf_host_<hash>.so
// (no -march=native: a build never holds code for another CPU).

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>

// ---------------------------------------------------------------------------
// Threading helper (C++ internals, outside the C ABI)

// the cores this process may run on (its affinity mask), not the machine's
static unsigned hw_threads() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) {
    int n = CPU_COUNT(&set);
    if (n > 0) return (unsigned)n;
  }
  unsigned t = std::thread::hardware_concurrency();
  return t ? t : 4;
}

// fn(lo, hi) over [0, n) cut into one contiguous range a thread
template <typename F>
static void parallel_for(int64_t n, F&& fn) {
  unsigned nt = hw_threads();
  if (n < (int64_t)nt * 1024) {
    fn((int64_t)0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Matrix Market loader
//
// Reads a `%%MatrixMarket matrix coordinate <field> <symmetry>` file into
// COO arrays with the entries, their order and their float32 values of
// scipy.io.mmread(path).tocoo():
//   * field real (or double), integer or pattern (values 1); complex is
//     refused;
//   * symmetry general, symmetric, skew-symmetric or hermitian (which, its
//     field being real, is symmetric).  The file's entries come first, in
//     file order, then the mirror of each off-diagonal entry, in file order:
//     (c, r, v) for symmetric and hermitian, (c, r, -v) for skew-symmetric;
//   * an integer value is converted from int64 to float32 once, a real one
//     from its double;
//   * a row or column outside the size line's bounds, a malformed line, or
//     more or fewer entries than the size line declares is a format error.
// Blank lines are skipped; after a value the rest of its line is ignored.
// The file is mapped, not copied; its entry lines are cut into one range a
// thread, and each range is parsed straight into the output arrays.

extern "C" {

struct MtxResult {
  int64_t rows, cols, nnz;
  int32_t* row_idx;  // caller frees via nmf_free
  int32_t* col_idx;
  float* values;
  int32_t error;  // 0 ok; 1 io; 2 format
};

}  // extern "C"

namespace {

enum Field { kReal, kInteger, kPattern };
enum Symmetry { kGeneral, kSymmetric, kSkew };

bool is_blank(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

const char* skip_blanks(const char* p, const char* e) {
  while (p < e && is_blank(*p)) ++p;
  return p;
}

const char* line_end(const char* p, const char* e) {
  const void* q = std::memchr(p, '\n', e - p);
  return q ? (const char*)q : e;
}

// A number at q (q < le) by std::from_chars, which takes what scipy's
// parser takes (no '+' sign, no hex float) and rounds correctly.  A real out
// of double's range is read again by strtod, from a copy of its token, for
// its value (inf, or 0 or a subnormal), as scipy gives it; an integer out of
// range is refused.  Returns the end of the number, or nullptr.
const char* parse_int(const char* q, const char* le, long long* v) {
  auto r = std::from_chars(q, le, *v);
  return r.ec == std::errc() ? r.ptr : nullptr;
}

const char* parse_real(const char* q, const char* le, double* v) {
  auto r = std::from_chars(q, le, *v);
  if (r.ec == std::errc::result_out_of_range)
    *v = std::strtod(std::string(q, r.ptr).c_str(), nullptr);
  return r.ec == std::errc() || r.ec == std::errc::result_out_of_range ? r.ptr
                                                                       : nullptr;
}

// One whole integer token of [q, le): it must end at a blank or at le.
bool parse_index(const char*& q, const char* le, long long* v) {
  q = skip_blanks(q, le);
  if (q >= le) return false;
  const char* after = parse_int(q, le, v);
  if (!after || (after < le && !is_blank(*after))) return false;
  q = after;
  return true;
}

// The value token of [q, le); what follows it on the line is ignored.
bool parse_value(const char*& q, const char* le, Field field, float* v) {
  if (field == kPattern) {
    *v = 1.0f;
    return true;
  }
  q = skip_blanks(q, le);
  if (q >= le) return false;
  const char* after;
  if (field == kInteger) {
    long long x;
    after = parse_int(q, le, &x);
    *v = (float)x;
  } else {
    double x;
    after = parse_real(q, le, &x);
    *v = (float)x;
  }
  if (!after) return false;
  q = after;
  return true;
}

std::string lower(std::string s) {
  for (auto& c : s) c = (char)std::tolower((unsigned char)c);
  return s;
}

// The file mapped read-only; every read of it is bounded by its end.
struct Mapped {
  const char* p = nullptr;
  size_t size = 0;
  ~Mapped() {
    if (p) munmap((void*)p, size);
  }
};

// The three output arrays, freed unless handed to the caller.
struct Outputs {
  int32_t* r = nullptr;
  int32_t* c = nullptr;
  float* v = nullptr;
  ~Outputs() {
    std::free(r);
    std::free(c);
    std::free(v);
  }
};

int32_t load_mtx(const char* path, MtxResult* out) {
  Mapped file;
  {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return 1;
    }
    file.size = (size_t)st.st_size;
    if (file.size == 0) {
      close(fd);
      return 2;
    }
    void* m = mmap(nullptr, file.size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (m == MAP_FAILED) return 1;
    file.p = (const char*)m;
  }
  const char* p = file.p;
  const char* end = p + file.size;

  // the banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  const char* le = line_end(p, end);
  std::vector<std::string> tok;
  for (const char* q = p; q < le;) {
    q = skip_blanks(q, le);
    const char* s = q;
    while (q < le && !is_blank(*q)) ++q;
    if (q > s) tok.emplace_back(s, q);
  }
  if (tok.size() < 5 || tok[0] != "%%MatrixMarket" || lower(tok[1]) != "matrix" ||
      lower(tok[2]) != "coordinate")
    return 2;
  Field field;
  std::string fs = lower(tok[3]), ss = lower(tok[4]);
  if (fs == "real" || fs == "double")
    field = kReal;
  else if (fs == "integer")
    field = kInteger;
  else if (fs == "pattern")
    field = kPattern;
  else
    return 2;  // complex, or no field at all
  Symmetry sym;
  if (ss == "general")
    sym = kGeneral;
  else if (ss == "symmetric" || ss == "hermitian")
    sym = kSymmetric;
  else if (ss == "skew-symmetric")
    sym = kSkew;
  else
    return 2;  // no symmetry at all
  p = le < end ? le + 1 : end;

  // comment and blank lines, then the size line: rows cols entries
  long long rows = 0, cols = 0, nnz = 0;
  for (;;) {
    if (p >= end) return 2;
    le = line_end(p, end);
    const char* q = skip_blanks(p, le);
    const char* next = le < end ? le + 1 : end;
    if (q == le || *q == '%') {
      p = next;
      continue;
    }
    if (!parse_index(q, le, &rows) || !parse_index(q, le, &cols) ||
        !parse_index(q, le, &nnz) || skip_blanks(q, le) != le)
      return 2;
    p = next;
    break;
  }
  if (rows < 0 || cols < 0 || nnz < 0 || rows > INT32_MAX || cols > INT32_MAX)
    return 2;

  // the entry lines, one range a thread (one thread below 1 MiB), each range
  // starting at a line
  int64_t data_len = end - p;
  unsigned nt = std::max<int64_t>(
      1, std::min<int64_t>(hw_threads(), data_len >> 20));
  std::vector<const char*> starts(nt + 1);
  for (unsigned t = 0; t < nt; ++t) {
    const char* s = p + (data_len * t) / nt;
    if (t > 0)
      while (s < end && *(s - 1) != '\n') ++s;
    starts[t] = s;
  }
  starts[nt] = end;
  auto per_thread = [nt](auto&& body) {
    std::vector<std::thread> th;
    for (unsigned t = 0; t < nt; ++t) th.emplace_back([&body, t] { body(t); });
    for (auto& x : th) x.join();
  };

  // a range's lines: its newlines, and the file's last line if it has no
  // newline and the range parses it, i.e. ends at the file's end and is not
  // empty (ranges whose start snapped to the end are empty, so this range
  // need not be the last).  Every range writes its entries, and its
  // mirrors, from the offset of its first line on, so the outputs need no
  // copy where every line holds an entry.
  std::vector<int64_t> lines(nt + 1, 0);
  per_thread([&](unsigned t) {
    lines[t + 1] = std::count(starts[t], starts[t + 1], '\n') +
                   (starts[t + 1] == end && starts[t] < end && end[-1] != '\n');
  });
  for (unsigned t = 0; t < nt; ++t) lines[t + 1] += lines[t];
  int64_t cap = lines[nt];
  int64_t mirror_at = cap;  // the mirrors' region, after the entries'
  size_t total_cap = (size_t)std::max<int64_t>(sym != kGeneral ? 2 * cap : cap, 1);
  Outputs o;
  o.r = (int32_t*)std::malloc(total_cap * sizeof(int32_t));
  o.c = (int32_t*)std::malloc(total_cap * sizeof(int32_t));
  o.v = (float*)std::malloc(total_cap * sizeof(float));
  if (!o.r || !o.c || !o.v) return 1;

  std::vector<int64_t> n_own(nt, 0), n_mirror(nt, 0);
  std::atomic<int> err{0};
  per_thread([&](unsigned t) {
    int64_t w = lines[t], m = mirror_at + lines[t];
    const char* q = starts[t];
    const char* qe = starts[t + 1];
    while (q < qe) {
      const char* lend = line_end(q, qe);
      const char* next = lend < qe ? lend + 1 : qe;
      const char* s = skip_blanks(q, lend);
      q = next;
      if (s == lend) continue;  // a blank line
      long long r, c;
      float v;
      if (!parse_index(s, lend, &r) || !parse_index(s, lend, &c) ||
          !parse_value(s, lend, field, &v) || r < 1 || r > rows || c < 1 ||
          c > cols) {
        err = 2;
        return;
      }
      o.r[w] = (int32_t)(r - 1);
      o.c[w] = (int32_t)(c - 1);
      o.v[w++] = v;
      if (sym != kGeneral && r != c) {
        o.r[m] = (int32_t)(c - 1);
        o.c[m] = (int32_t)(r - 1);
        o.v[m++] = sym == kSkew ? -v : v;
      }
    }
    n_own[t] = w - lines[t];
    n_mirror[t] = m - mirror_at - lines[t];
  });
  if (err) return err;

  // close the gaps blank lines and unmirrored diagonal entries left: the
  // entries in range order, then the mirrors in range order.  Each part
  // moves down, after the parts before it, so no move overwrites a part
  // not yet moved.
  int64_t w = 0;
  auto move_down = [&](int64_t from, int64_t n) {
    if (from != w && n) {
      std::memmove(o.r + w, o.r + from, n * sizeof(int32_t));
      std::memmove(o.c + w, o.c + from, n * sizeof(int32_t));
      std::memmove(o.v + w, o.v + from, n * sizeof(float));
    }
    w += n;
  };
  for (unsigned t = 0; t < nt; ++t) move_down(lines[t], n_own[t]);
  if (w != nnz) return 2;
  for (unsigned t = 0; t < nt; ++t) move_down(mirror_at + lines[t], n_mirror[t]);

  out->rows = rows;
  out->cols = cols;
  out->nnz = w;
  out->row_idx = o.r;
  out->col_idx = o.c;
  out->values = o.v;
  o.r = o.c = nullptr;
  o.v = nullptr;
  return 0;
}

}  // namespace

extern "C" {

int32_t nmf_load_mtx(const char* path, MtxResult* out) {
  std::memset(out, 0, sizeof(*out));
  out->error = load_mtx(path, out);
  return out->error;
}

void nmf_free(void* ptr) { std::free(ptr); }

// ---------------------------------------------------------------------------
// COO -> CSR with duplicates summed: the bits of scipy's
// coo_matrix(...).tocsr().  Entries go to their rows in entry order (a
// counting sort, scipy's coo_tocsr).  If every row's columns are then in
// non-decreasing order they stay in entry order; otherwise every row is
// sorted by column with std::sort on (column, value) pairs compared by
// column alone, as scipy's csr_sort_indices does.  Equal columns are then
// added in float32, left to right (csr_sum_duplicates).  std::sort is not
// stable: in a row of more than 16 entries that needs sorting, the order in
// which three or more duplicates are added is that of the standard
// library's introsort.  Built with g++ (libstdc++, as scipy's Linux wheels
// are) the bits are scipy's; with another standard library such sums may
// differ in their last bits.  Returns the number of entries left, or -1 if a
// row or column is out of range.

int64_t nmf_coo_to_csr(int64_t rows, int64_t cols, int64_t nnz,
                       const int32_t* row_idx, const int32_t* col_idx,
                       const float* values, int64_t* indptr /* rows+1 */,
                       int32_t* indices /* nnz */, float* data /* nnz */) {
  for (int64_t i = 0; i < nnz; ++i)
    if (row_idx[i] < 0 || row_idx[i] >= rows || col_idx[i] < 0 ||
        col_idx[i] >= cols)
      return -1;
  std::vector<int64_t> start(rows + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) start[row_idx[i] + 1]++;
  for (int64_t r = 0; r < rows; ++r) start[r + 1] += start[r];
  {
    std::vector<int64_t> pos(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < nnz; ++i) {
      int64_t p = pos[row_idx[i]]++;
      indices[p] = col_idx[i];
      data[p] = values[i];
    }
  }
  std::atomic<bool> sorted{true};
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi && sorted.load(std::memory_order_relaxed); ++r)
      for (int64_t i = start[r] + 1; i < start[r + 1]; ++i)
        if (indices[i - 1] > indices[i]) {
          sorted = false;
          return;
        }
  });
  std::vector<int64_t> newlen(rows, 0);
  bool sort_rows = !sorted;
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<int32_t, float>> tmp;
    for (int64_t r = lo; r < hi; ++r) {
      int64_t s = start[r], e = start[r + 1];
      if (sort_rows) {
        tmp.resize(e - s);
        for (int64_t i = s; i < e; ++i) tmp[i - s] = {indices[i], data[i]};
        std::sort(tmp.begin(), tmp.end(),
                  [](const std::pair<int32_t, float>& a,
                     const std::pair<int32_t, float>& b) {
                    return a.first < b.first;
                  });
        for (int64_t i = s; i < e; ++i) {
          indices[i] = tmp[i - s].first;
          data[i] = tmp[i - s].second;
        }
      }
      int64_t w = s;
      for (int64_t i = s; i < e;) {
        int32_t j = indices[i];
        float x = data[i++];
        while (i < e && indices[i] == j) x += data[i++];
        indices[w] = j;
        data[w++] = x;
      }
      newlen[r] = w - s;
    }
  });
  int64_t w = 0;
  indptr[0] = 0;
  for (int64_t r = 0; r < rows; ++r) {
    int64_t s = start[r];
    if (w != s) {
      std::memmove(indices + w, indices + s, newlen[r] * sizeof(int32_t));
      std::memmove(data + w, data + s, newlen[r] * sizeof(float));
    }
    w += newlen[r];
    indptr[r + 1] = w;
  }
  return w;
}

// ---------------------------------------------------------------------------
// The store binner's passes (ops/sparse_format.py, ops/sparse_shard.py)

// Stable LSD radix argsort of non-negative int64 keys (8-bit digits; the
// passes above the largest key's top digit are skipped).  Parallel histogram
// and a per-thread scatter: thread t's write offset for digit d is the count
// of d in threads before t plus all smaller digits, so each thread's slice
// keeps its order and the sort is stable.  n < 2^31 (int32 payload).
int64_t nmf_argsort64(int64_t n, const int64_t* keys, int64_t* order) {
  if (n <= 0) return 0;
  int64_t maxk = 0;
  for (int64_t i = 0; i < n; ++i)
    if (keys[i] > maxk) maxk = keys[i];
  int passes = 1;
  while (passes < 8 && (maxk >> (8 * passes)) != 0) ++passes;

  std::vector<int64_t> kbuf_a(keys, keys + n), kbuf_b(n);
  std::vector<int32_t> ibuf_a(n), ibuf_b(n);
  for (int64_t i = 0; i < n; ++i) ibuf_a[i] = (int32_t)i;
  int64_t* ksrc = kbuf_a.data();
  int64_t* kdst = kbuf_b.data();
  int32_t* isrc = ibuf_a.data();
  int32_t* idst = ibuf_b.data();

  unsigned nt = hw_threads();
  int64_t chunk = (n + nt - 1) / nt;
  std::vector<int64_t> hist(nt * 256);
  auto per_thread = [&](auto&& body) {  // body(t) on its own thread
    std::vector<std::thread> th;
    for (unsigned t = 0; t < nt; ++t) th.emplace_back([&body, t] { body(t); });
    for (auto& x : th) x.join();
  };

  for (int p = 0; p < passes; ++p) {
    int shift = 8 * p;
    std::fill(hist.begin(), hist.end(), 0);
    per_thread([&](unsigned t) {
      int64_t lo = (int64_t)t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      int64_t* h = hist.data() + (int64_t)t * 256;
      for (int64_t i = lo; i < hi; ++i) ++h[(ksrc[i] >> shift) & 0xFF];
    });
    // exclusive prefix over (digit, thread)
    int64_t run = 0;
    for (int d = 0; d < 256; ++d) {
      for (unsigned t = 0; t < nt; ++t) {
        int64_t& c = hist[t * 256 + d];
        int64_t tmp = c;
        c = run;
        run += tmp;
      }
    }
    per_thread([&](unsigned t) {
      int64_t lo = (int64_t)t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      int64_t* off = hist.data() + (int64_t)t * 256;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t w = off[(ksrc[i] >> shift) & 0xFF]++;
        kdst[w] = ksrc[i];
        idst[w] = isrc[i];
      }
    });
    std::swap(ksrc, kdst);
    std::swap(isrc, idst);
  }
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) order[i] = isrc[i];
  });
  return 0;
}

// Each pass below checks every index it reads or writes through against the
// length it is given and returns -1, having written nothing past an array,
// where one is out of range (0 otherwise).  Its wrapper in io/loader.py
// raises then.

// out[i] = src[order[i]] for the three binning arrays in one parallel pass;
// the sources hold n_src entries.
int64_t nmf_gather3(int64_t n, const int64_t* order, int64_t n_src,
                    const int32_t* r, const int32_t* c, const float* v,
                    int32_t* ro, int32_t* co, float* vo) {
  std::atomic<bool> bad{false};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t o = order[i];
      if ((uint64_t)o >= (uint64_t)n_src) {
        bad = true;
        return;
      }
      ro[i] = r[o];
      co[i] = c[o];
      vo[i] = v[o];
    }
  });
  return bad ? -1 : 0;
}

// The fused tile key ((r/128)/st * ncp + c/128) * st + (r/128)%st of
// non-negative rows and columns, in one pass (-1: a negative one, where C's
// division would not be numpy's).
int64_t nmf_tile_key(int64_t n, const int32_t* rows, const int32_t* cols,
                     int64_t n_colpanels, int64_t stripe_tiles, int64_t* key) {
  std::atomic<bool> bad{false};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (rows[i] < 0 || cols[i] < 0) {
        bad = true;
        return;
      }
      int64_t rp = rows[i] >> 7;
      key[i] = ((rp / stripe_tiles) * n_colpanels + (cols[i] >> 7)) *
                   stripe_tiles +
               rp % stripe_tiles;
    }
  });
  return bad ? -1 : 0;
}

// gather3 plus the key array in the same pass.
int64_t nmf_gather3k(int64_t n, const int64_t* order, int64_t n_src,
                     const int32_t* r, const int32_t* c, const float* v,
                     const int64_t* k, int32_t* ro, int32_t* co, float* vo,
                     int64_t* ko) {
  std::atomic<bool> bad{false};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t o = order[i];
      if ((uint64_t)o >= (uint64_t)n_src) {
        bad = true;
        return;
      }
      ro[i] = r[o];
      co[i] = c[o];
      vo[i] = v[o];
      ko[i] = k[o];
    }
  });
  return bad ? -1 : 0;
}

// Chunk-store fill: one pass over the tile-sorted residual gives every
// nonzero its chunk slot and writes coords / vals / slot ids.  Parallel over
// tiles; a tile's slots are written by one thread.
//   t_first[t], counts[t]: the tile's range in the nnz sorted residual
//   entries
//   base[t]: the tile's first chunk index (group-padded layout)
//   coords, vals: the n_slots flat chunk-store slots
//   slot_out[i]: flat chunk-store slot of residual nonzero i
int64_t nmf_chunk_fill(int64_t ntiles, const int64_t* t_first,
                       const int64_t* counts, const int64_t* base,
                       const int32_t* s_rows, const int32_t* s_cols,
                       const float* s_vals, int64_t nnz, int64_t cwidth,
                       int32_t* coords, float* vals, int64_t n_slots,
                       int64_t* slot_out) {
  std::atomic<bool> bad{false};
  parallel_for(ntiles, [&](int64_t lo, int64_t hi) {
    for (int64_t t = lo; t < hi; ++t) {
      int64_t first = t_first[t];
      int64_t cnt = counts[t];
      int64_t b = base[t];
      if (first < 0 || cnt < 0 || cnt > nnz - first || b < 0 ||
          b > n_slots / 128 - (cnt + 127) / 128) {
        bad = true;
        return;
      }
      for (int64_t p = 0; p < cnt; ++p) {
        int64_t i = first + p;
        int64_t gslot = (b + (p >> 7)) * 128 + (p & 127);
        coords[gslot] =
            (int32_t)(((s_cols[i] % cwidth) << 7) | (s_rows[i] & 127));
        vals[gslot] = s_vals[i];
        slot_out[i] = gslot;
      }
    }
  });
  return bad ? -1 : 0;
}

// Class partition: tiles are contiguous runs of the n sorted entries; each
// tile's run is copied to its class's region of the n outputs (dst[t]: the
// class-major offset of tile t, which the caller computes over the per-tile
// arrays), ``order`` (the CSR ids) carried along.  Plain element loops: most
// tiles hold a handful of nonzeros.
int64_t nmf_class_extract(int64_t ntiles, const int64_t* t_first,
                          const int64_t* counts, const int64_t* dst,
                          const int32_t* a_rows, const int32_t* a_cols,
                          const float* a_vals, const int64_t* order, int64_t n,
                          int32_t* ro, int32_t* co, float* vo, int64_t* oo) {
  std::atomic<bool> bad{false};
  parallel_for(ntiles, [&](int64_t lo, int64_t hi) {
    for (int64_t t = lo; t < hi; ++t) {
      int64_t src = t_first[t];
      int64_t d = dst[t];
      int64_t cnt = counts[t];
      if (src < 0 || d < 0 || cnt < 0 || cnt > n - src || cnt > n - d) {
        bad = true;
        return;
      }
      for (int64_t i = 0; i < cnt; ++i) {
        ro[d + i] = a_rows[src + i];
        co[d + i] = a_cols[src + i];
        vo[d + i] = a_vals[src + i];
        oo[d + i] = order[src + i];
      }
    }
  });
  return bad ? -1 : 0;
}

// dvals[blk[i]][lcol[i]][lrow[i]] = v[i] over n_blocks 128 x 128 blocks.
// Positions are unique (deduplicated COO), so the parallel writes cannot
// race.
int64_t nmf_dense_scatter(int64_t n, const int64_t* blk, const int32_t* lcol,
                          const int32_t* lrow, const float* v, float* dvals,
                          int64_t n_blocks) {
  std::atomic<bool> bad{false};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if ((uint64_t)blk[i] >= (uint64_t)n_blocks || (uint32_t)lcol[i] >= 128 ||
          (uint32_t)lrow[i] >= 128) {
        bad = true;
        return;
      }
      dvals[blk[i] * (128 * 128) + (int64_t)lcol[i] * 128 + lrow[i]] = v[i];
    }
  });
  return bad ? -1 : 0;
}

}  // extern "C"
