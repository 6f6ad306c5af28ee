// fastcsv: multi-threaded numeric CSV matrix parser for the host.
//
// flexynesis_torch's copy of native/fastcsv.cpp, with the same semantics:
// pandas.read_csv is single-threaded and type-inferring, and for a
// 20k-feature x 2k-sample matrix it is the dominant startup cost. This loader
// mmaps the file, splits it into per-thread line ranges and parses straight
// into one contiguous float32 buffer. Each cell is parsed by std::from_chars
// into a float, one correctly rounded conversion from the decimal text.
//
// Layout expectations (flexynesis CSV convention):
//   header:  ,S1,S2,...   (first cell empty or an index name)
//   rows:    feature_id,1.0,2.5,...
// Missing values (pandas' default NA tokens, exactly) parse to NaN. A file
// this parser cannot represent exactly as pandas reads it (quotes, an R-style
// header, ragged rows, non-numeric cells) is refused through `error`, and the
// caller reads it another way.
//
// C ABI (consumed via ctypes from flexynesis_torch/data/fastcsv.py; built by
// flexynesis_torch/kernels/build.py with g++):
//   FcsvMatrix* fastcsv_read(const char* path, int n_threads)
//   void        fastcsv_free(FcsvMatrix*)

#include <atomic>
#include <charconv>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct FcsvMatrix {
  float* data;          // n_rows * n_cols, row-major
  int64_t n_rows;
  int64_t n_cols;
  char* row_names;      // '\0'-separated, n_rows entries
  int64_t row_names_len;
  char* col_names;      // '\0'-separated, n_cols entries
  int64_t col_names_len;
  char* error;          // non-null on failure
};

}  // extern "C"

namespace {

// pandas' default NA tokens (io.parsers STR_NA_VALUES) — matched EXACTLY
// (case-sensitive, untrimmed), because pandas does: 'NAN', 'Null', ' NA '
// are all typed as str by pandas, so the native path must refuse them
// rather than silently coerce to NaN (match-or-refuse contract).
static const char* const kNaTokens[] = {
    "NA", "NaN", "nan", "NULL", "null", "None", "N/A", "n/a", "-NaN",
    "-nan", "<NA>", "#N/A", "#NA", "#N/A N/A", "1.#IND", "1.#QNAN",
    "-1.#IND", "-1.#QNAN",
};

// slow path: NA tokens, space trimming, inf/nan spelling checks — taken
// only when the direct numeric parse below doesn't cleanly consume the
// field (NA cells, padded/garbage fields; ~0% of an omics matrix)
inline const char* parse_float_slow(const char* p, const char* end, float* out,
                                    bool* ok) {
  const char* raw_start = p;
  const char* q = p;
  while (q < end && *q != ',' && *q != '\n' && *q != '\r') ++q;
  const char* raw_end = q;
  size_t raw_len = static_cast<size_t>(raw_end - raw_start);
  if (raw_len == 0) {  // truly empty field -> NaN (pandas agrees)
    *out = NAN;
    return q;
  }
  for (const char* tok : kNaTokens) {
    size_t n = strlen(tok);
    if (raw_len == n && memcmp(raw_start, tok, n) == 0) {
      *out = NAN;
      return q;
    }
  }
  // numeric parse: spaces trimmed both sides (pandas accepts " 1.5 ")
  const char* fs = raw_start;
  while (fs < raw_end && *fs == ' ') ++fs;
  const char* fe = raw_end;
  while (fe > fs && fe[-1] == ' ') --fe;
  if (fs == fe) {  // spaces-only field: pandas semantics unclear -> refuse
    *ok = false;
    *out = NAN;
    return q;
  }
  float v;
  auto res = std::from_chars(fs, fe, v);
  // the whole field must be numeric: trailing garbage ("12x", a mid-field
  // quote) means pandas would type the column as object — abort to the
  // pandas fallback instead of silently coercing to the numeric prefix
  if (res.ec != std::errc() || res.ptr != fe) {
    *ok = false;
    *out = NAN;
    return q;
  }
  // from_chars accepts case-variant nan/inf spellings ("NAN", "Inf") that
  // pandas types as str; only the exact spellings pandas parses pass
  if (std::isnan(v)) {  // nan-token fields were handled above
    *ok = false;
    return q;
  }
  if (std::isinf(v)) {
    size_t n = static_cast<size_t>(fe - fs);
    bool exact = (n == 3 && memcmp(fs, "inf", 3) == 0) ||
                 (n == 4 && (memcmp(fs, "-inf", 4) == 0 ||
                             memcmp(fs, "+inf", 4) == 0));
    if (!exact) {  // "Inf", "INFINITY", ... -> refuse, pandas decides
      *ok = false;
      return q;
    }
  }
  *out = v;
  return q;
}

// fast path: one direct from_chars per field. The field is fully consumed
// iff the parse stops exactly at a delimiter (or EOF); finite values pass
// straight through — 18-token NA scans and trimming only run on the slow
// path. Measured ~2x on a 5k x 1k matrix (the parse was NA-scan-bound).
inline const char* parse_float(const char* p, const char* end, float* out,
                               bool* ok) {
  float v;
  auto res = std::from_chars(p, end, v);
  if (res.ec == std::errc() && res.ptr > p) {
    char nxt = res.ptr < end ? *res.ptr : ',';
    if ((nxt == ',' || nxt == '\n' || nxt == '\r') && !std::isnan(v) &&
        !std::isinf(v)) {
      *out = v;
      return res.ptr;
    }
  }
  return parse_float_slow(p, end, out, ok);
}

struct LineIndex {
  std::vector<const char*> starts;  // start of each data line (after header)
};

}  // namespace

extern "C" FcsvMatrix* fastcsv_read(const char* path, int n_threads) {
  auto* m = new FcsvMatrix();
  memset(m, 0, sizeof(FcsvMatrix));

  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    m->error = strdup("fastcsv: cannot open file");
    return m;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    m->error = strdup("fastcsv: empty or unreadable file");
    return m;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* buf =
      static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (buf == MAP_FAILED) {
    m->error = strdup("fastcsv: mmap failed");
    return m;
  }
  const char* end = buf + size;

  // ---- header: column (sample) names -----------------------------------
  const char* p = buf;
  const char* header_end = static_cast<const char*>(memchr(p, '\n', size));
  if (!header_end) {
    munmap(const_cast<char*>(buf), size);
    m->error = strdup("fastcsv: no newline in file");
    return m;
  }
  std::string col_blob;
  int64_t n_cols = 0;
  {
    const char* q = p;
    // skip the first (index) cell
    while (q < header_end && *q != ',') ++q;
    while (q < header_end) {
      ++q;  // skip comma
      const char* s = q;
      while (q < header_end && *q != ',' && *q != '\r') ++q;
      col_blob.append(s, static_cast<size_t>(q - s));
      col_blob.push_back('\0');
      ++n_cols;
      while (q < header_end && *q == '\r') ++q;
    }
  }

  // ---- index data lines --------------------------------------------------
  LineIndex idx;
  for (const char* q = header_end + 1; q < end;) {
    idx.starts.push_back(q);
    const char* nl = static_cast<const char*>(
        memchr(q, '\n', static_cast<size_t>(end - q)));
    if (!nl) break;
    q = nl + 1;
  }
  // drop a trailing empty line
  while (!idx.starts.empty()) {
    const char* s = idx.starts.back();
    if (s >= end || *s == '\n' || *s == '\r') idx.starts.pop_back();
    else break;
  }
  int64_t n_rows = static_cast<int64_t>(idx.starts.size());

  // ---- layout sanity checks ---------------------------------------------
  // Two input shapes this fast path cannot represent are detected up front
  // so the caller falls back to pandas instead of silently misparsing:
  //  * quoted fields (may contain commas) anywhere in the header or the
  //    first data row, and
  //  * R-style headers with no leading index cell (header has one fewer
  //    field than the data rows) — naive parsing would shift every column
  //    label by one and drop the last data column.
  {
    auto count_commas = [](const char* s, const char* e) {
      int64_t n = 0;
      for (; s < e; ++s)
        if (*s == ',') ++n;
      return n;
    };
    const char* first_row = n_rows > 0 ? idx.starts[0] : nullptr;
    const char* first_row_end = end;
    if (first_row) {
      const char* nl = static_cast<const char*>(
          memchr(first_row, '\n', static_cast<size_t>(end - first_row)));
      first_row_end = nl ? nl : end;
    }
    bool quoted =
        memchr(p, '"', static_cast<size_t>(header_end - p)) != nullptr ||
        (first_row &&
         memchr(first_row, '"',
                static_cast<size_t>(first_row_end - first_row)) != nullptr);
    if (quoted) {
      munmap(const_cast<char*>(buf), size);
      m->error = strdup("fastcsv: quoted fields not supported");
      return m;
    }
    if (first_row) {
      int64_t hdr_fields = count_commas(p, header_end) + 1;
      int64_t row_fields = count_commas(first_row, first_row_end) + 1;
      if (row_fields != hdr_fields) {
        munmap(const_cast<char*>(buf), size);
        m->error =
            strdup("fastcsv: header/data field-count mismatch (R-style "
                   "header or ragged row)");
        return m;
      }
    }
  }

  float* data = static_cast<float*>(
      malloc(sizeof(float) * static_cast<size_t>(n_rows * n_cols)));
  std::vector<std::string> row_names(static_cast<size_t>(n_rows));
  std::atomic<bool> failed{false};

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int T = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (T > n_rows) T = n_rows > 0 ? static_cast<int>(n_rows) : 1;

  // every row is validated as it parses: a quote anywhere or a field count
  // that differs from the header aborts the whole parse so the caller falls
  // back to pandas — the up-front header/first-row check alone would let a
  // ragged or quoted row deeper in the file silently shift columns
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi && !failed.load(std::memory_order_relaxed); ++r) {
      const char* q = idx.starts[static_cast<size_t>(r)];
      const char* name_start = q;
      while (q < end && *q != ',' && *q != '\n') {
        if (*q == '"') { failed.store(true); return; }
        ++q;
      }
      row_names[static_cast<size_t>(r)].assign(
          name_start, static_cast<size_t>(q - name_start));
      float* row = data + r * n_cols;
      int64_t c = 0;
      bool row_ok = true;
      while (q < end && *q == ',' && c < n_cols) {
        ++q;
        if (q < end && *q == '"') { failed.store(true); return; }
        q = parse_float(q, end, &row[c], &row_ok);
        if (!row_ok) { failed.store(true); return; }
        ++c;
      }
      // the row must hold exactly n_cols fields and be fully consumed
      if (c != n_cols ||
          (q < end && *q != '\n' && *q != '\r')) {
        failed.store(true);
        return;
      }
    }
  };

  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n_rows);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  munmap(const_cast<char*>(buf), size);

  if (failed.load()) {
    free(data);
    m->error = strdup(
        "fastcsv: quoted, non-numeric, or miscounted field in a data row");
    return m;
  }

  std::string row_blob;
  for (auto& s : row_names) {
    row_blob.append(s);
    row_blob.push_back('\0');
  }

  m->data = data;
  m->n_rows = n_rows;
  m->n_cols = n_cols;
  m->row_names = static_cast<char*>(malloc(row_blob.size()));
  memcpy(m->row_names, row_blob.data(), row_blob.size());
  m->row_names_len = static_cast<int64_t>(row_blob.size());
  m->col_names = static_cast<char*>(malloc(col_blob.size()));
  memcpy(m->col_names, col_blob.data(), col_blob.size());
  m->col_names_len = static_cast<int64_t>(col_blob.size());
  return m;
}

extern "C" void fastcsv_free(FcsvMatrix* m) {
  if (!m) return;
  free(m->data);
  free(m->row_names);
  free(m->col_names);
  free(m->error);
  delete m;
}
