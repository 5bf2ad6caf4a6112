// The port's host CSV reader: numeric CSV -> float64 in one strtod pass.
//
// The data layer parses every client's shards before round 0: at the
// 10-client N-BaIoT scale ~70 MB of numeric text. This is a single-pass,
// zero-allocation-per-field parser behind a plain C interface, loaded
// through ctypes by fedmse_tpu_torch/data/fast_csv.py; ctypes releases the
// GIL during the call, so a directory's files parse on a thread pool.
// strtod is correctly rounded, so the values are the bits of any
// correctly rounded parser (numpy's loadtxt, pandas' round-trip parser).
//
// Scope: headerless rows of decimal or scientific floats separated by
// commas (the shards fedmse_tpu_torch/data/prep.py writes); '\n' or
// '\r\n' line endings; blank lines ignored. A header line (a first
// field that is not numeric) is detected and reported so the caller can
// skip or refuse it. A short or wide row is an error, never truncated.
//
// Built by fedmse_tpu_torch/ops/native.py with $CXX or g++ into
// build/fedmse_tpu_torch/ at first use.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>

namespace {

// Read the whole file into a malloc'd, NUL-terminated buffer.
char* read_file(const char* path, long* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) { std::fclose(f); return nullptr; }
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(size) + 1));
  if (!buf) { std::fclose(f); return nullptr; }
  long got = static_cast<long>(std::fread(buf, 1, static_cast<size_t>(size), f));
  std::fclose(f);
  if (got != size) { std::free(buf); return nullptr; }
  buf[size] = '\0';
  *size_out = size;
  return buf;
}

// True if the first line's first field does not parse as a float => header.
bool sniff_header(const char* buf) {
  const char* p = buf;
  while (*p == ' ' || *p == '\t') ++p;
  char* end = nullptr;
  std::strtof(p, &end);
  if (end == p) return true;  // not numeric at all
  // numeric prefix but a stray non-separator suffix (e.g. "MI_dir_L5_weight")
  while (*end == ' ' || *end == '\t') ++end;
  return !(*end == ',' || *end == '\n' || *end == '\r' || *end == '\0');
}

}  // namespace

extern "C" {

// Scan the file once: report rows (data rows only), columns of the first data
// row, and whether a header line was detected (and must be skipped on parse).
// Returns 0 on success, negative errno-style codes on failure.
int fedmse_csv_dims(const char* path, long* rows, long* cols, int* has_header) {
  long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;

  *has_header = sniff_header(buf) ? 1 : 0;
  long r = 0, c = 0;
  long line_cols = 1;
  bool in_line = false;
  bool first_data_line = true;
  long line_no = 0;
  for (const char* p = buf; *p; ++p) {
    if (*p == '\n') {
      if (in_line) {
        if (line_no >= *has_header) {
          if (first_data_line) { c = line_cols; first_data_line = false; }
          ++r;
        }
        ++line_no;
      }
      in_line = false;
      line_cols = 1;
    } else if (*p == ',') {
      ++line_cols;
      in_line = true;
    } else if (*p != '\r') {
      in_line = true;
    }
  }
  if (in_line) {  // last line without trailing newline
    if (line_no >= *has_header) {
      if (first_data_line) c = line_cols;
      ++r;
    }
  }
  std::free(buf);
  *rows = r;
  *cols = c;
  return 0;
}

// Parse the file into out[rows*cols] (row-major float64; double precision
// so results are the bits of any correctly rounded parser). `skip_header`
// should be the has_header value from fedmse_csv_dims. Returns the number of
// rows actually parsed, or a negative code on IO/shape errors.
long fedmse_csv_parse(const char* path, double* out, long rows, long cols,
                      int skip_header) {
  long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;

  const char* p = buf;
  if (skip_header) {
    while (*p && *p != '\n') ++p;
    if (*p == '\n') ++p;
  }

  long r = 0;
  while (*p && r < rows) {
    // skip blank lines
    while (*p == '\n' || *p == '\r') ++p;
    if (!*p) break;
    long c = 0;
    while (c < cols) {
      char* end = nullptr;
      errno = 0;
      double v = std::strtod(p, &end);
      if (end == p) { std::free(buf); return -2; }  // malformed field
      out[r * cols + c] = v;
      p = end;
      ++c;
      if (*p == ',') {
        // a separator after the last expected field = wide (ragged) row;
        // reject rather than silently truncate
        if (c == cols) { std::free(buf); return -3; }
        ++p;
      } else {
        break;
      }
    }
    if (c != cols) { std::free(buf); return -3; }  // short (ragged) row
    // advance to next line
    while (*p && *p != '\n') ++p;
    if (*p == '\n') ++p;
    ++r;
  }
  std::free(buf);
  return r;
}

}  // extern "C"
