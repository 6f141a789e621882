// Native I/O engine: byte-range CSV parsing and chunked binary reads.
//
// Host counterpart of the reference's parallel CSV loader
// (heat/core/io.py:713): there each MPI rank reads a line-aligned byte
// range of the file; here one host process parses the whole file with a
// thread per byte range, producing a contiguous float32 buffer the caller
// shards onto the device mesh.  Same alignment rule as the reference:
// a range [start, end) skips past the first newline when start > 0 and
// finishes the line containing end-1.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Range {
  long start;
  long end;
};

// Align [start, end) to line boundaries within a file of size fsize.
Range align_to_lines(int fd, long start, long end, long fsize) {
  char buf[1];
  if (start > 0) {
    long pos = start - 1;  // start mid-line unless previous byte is '\n'
    while (pos < fsize) {
      if (pread(fd, buf, 1, pos) != 1) break;
      ++pos;
      if (buf[0] == '\n') break;
    }
    start = pos;
  }
  if (end < fsize) {
    long pos = end - 1;  // finish the line containing end-1
    while (pos < fsize) {
      if (pread(fd, buf, 1, pos) != 1) break;
      ++pos;
      if (buf[0] == '\n') break;
    }
    end = pos;
  } else {
    end = fsize;
  }
  if (start > end) start = end;
  return {start, end};
}

// Parse one line-aligned chunk of CSV text into floats.  Fields are scanned
// per line (a strtof bounded by the line, never across '\n'); every row must
// have the same field count — ragged input sets *ragged so the caller can
// fall back to the NumPy parser's error behavior.  Blank lines are skipped
// (np.genfromtxt semantics).
void parse_chunk(const char* data, long n, char delim,
                 std::vector<float>* out, long* rows, long* cols,
                 bool* ragged) {
  long r = 0;
  long ncols = -1;
  const char* p = data;
  const char* lim = data + n;
  char field[128];
  while (p < lim) {
    const char* nl = (const char*)memchr(p, '\n', lim - p);
    const char* line_end = nl ? nl : lim;
    // truncate at '#' (np.genfromtxt comments='#'), strip trailing '\r'/ws
    const char* le = line_end;
    const char* hash = (const char*)memchr(p, '#', line_end - p);
    if (hash) le = hash;
    while (le > p && (le[-1] == '\r' || le[-1] == ' ' || le[-1] == '\t')) --le;
    if (le > p) {
      long line_cols = 0;
      const char* f = p;
      while (true) {
        const char* fe = f;
        while (fe < le && *fe != delim) ++fe;
        long flen = fe - f;
        float v;
        if (flen <= 0) {
          v = __builtin_nanf("");
        } else {
          if (flen > (long)sizeof(field) - 1) flen = sizeof(field) - 1;
          memcpy(field, f, flen);
          field[flen] = '\0';
          char* next = nullptr;
          v = strtof(field, &next);
          if (next == field) v = __builtin_nanf("");
        }
        out->push_back(v);
        ++line_cols;
        if (fe >= le) break;
        f = fe + 1;
      }
      if (ncols < 0) ncols = line_cols;
      if (line_cols != ncols) *ragged = true;
      ++r;
    }
    p = nl ? nl + 1 : lim;
  }
  *rows = r;
  *cols = ncols < 0 ? 0 : ncols;
}

// Skip header_lines lines from the start of the file; returns the byte
// offset of the first data line.
long skip_header(int fd, long header_lines, long fsize) {
  long data_start = 0;
  char buf[1 << 16];
  long remaining = header_lines;
  while (remaining > 0 && data_start < fsize) {
    ssize_t got = pread(fd, buf, sizeof(buf), data_start);
    if (got <= 0) break;
    long i = 0;
    for (; i < got && remaining > 0; ++i)
      if (buf[i] == '\n') --remaining;
    data_start += i;
  }
  return data_start;
}

// Parse the line-aligned span [data_start, fsize) of an open file.  Same
// contract as ht_csv_parse below (which delegates here after the header
// skip).
long csv_parse_span(int fd, long data_start, long fsize, char delim,
                    int nthreads, float** out_data, long* out_rows);

}  // namespace

extern "C" {

// File size in bytes, or -1.
long ht_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return (long)st.st_size;
}

// Parse CSV [after skipping header_lines] with nthreads line-aligned byte
// ranges.  On success returns number of floats written to *out_data (caller
// frees with ht_free), sets *out_rows.  Returns -1 on error.
long ht_csv_parse(const char* path, long header_lines, char delim,
                  int nthreads, float** out_data, long* out_rows) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  long fsize = st.st_size;
  long data_start = skip_header(fd, header_lines, fsize);
  long ret = csv_parse_span(fd, data_start, fsize, delim, nthreads, out_data,
                            out_rows);
  close(fd);
  return ret;
}

// Parse only the byte range [start, end) — already line-aligned, header
// excluded (the slab-per-shard loader gets its bounds from
// ht_csv_row_bounds).  Same return contract as ht_csv_parse.
long ht_csv_parse_range(const char* path, long start, long end, char delim,
                        int nthreads, float** out_data, long* out_rows) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  if (end < 0 || end > st.st_size) end = st.st_size;
  if (start < 0) start = 0;
  if (start > end) start = end;
  long ret = csv_parse_span(fd, start, end, delim, nthreads, out_data,
                            out_rows);
  close(fd);
  return ret;
}

// Byte offsets of the shard row-boundaries for an even ceil(rows/nshards)
// partition of the file's data rows (the mesh chunk rule).  Writes
// nshards+1 offsets into out_bounds (bounds[k] = start of data row
// k*ceil(rows/nshards), clamped; bounds[nshards] = end of data) and the
// total data-row count into out_rows.  A row is counted iff it has any
// non-whitespace content before '#' — the same rule parse_chunk uses to
// skip blank/comment lines.  Returns 0 on success, -1 on error.
long ht_csv_row_bounds(const char* path, long header_lines, long nshards,
                       long* out_bounds, long* out_rows) {
  if (nshards < 1) return -1;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  long fsize = st.st_size;
  long data_start = skip_header(fd, header_lines, fsize);

  // streaming two-pass scan; line state survives buffer boundaries
  std::vector<char> buf(16 << 20);
  for (int pass = 0; pass < 2; ++pass) {
    long rows = pass == 0 ? 0 : *out_rows;
    long per = pass == 0 ? 0 : (rows + nshards - 1) / nshards;
    long row_idx = 0;
    long next_shard = 0;  // bounds[0] = first data row's line start
    long line_start = data_start;
    bool in_comment = false;
    bool counted = false;  // current line already counted as a data row
    long pos = data_start;
    if (pass == 1 && per == 0) {  // no data rows: every shard is empty
      while (next_shard <= nshards) out_bounds[next_shard++] = fsize;
      continue;
    }
    while (pos < fsize) {
      ssize_t got = pread(fd, buf.data(), buf.size(), pos);
      if (got <= 0) break;
      for (long i = 0; i < got; ++i) {
        char c = buf[i];
        if (c == '\n') {
          line_start = pos + i + 1;
          in_comment = false;
          counted = false;
        } else if (c == '#') {
          in_comment = true;
        } else if (!counted && !in_comment && c != ' ' && c != '\t' &&
                   c != '\r') {
          // first content character: this line is data row row_idx
          if (pass == 1) {
            while (next_shard < nshards && next_shard * per == row_idx) {
              out_bounds[next_shard] = line_start;
              ++next_shard;
            }
          }
          ++row_idx;
          counted = true;
        }
      }
      pos += got;
    }
    if (pass == 0) {
      *out_rows = row_idx;
    } else {
      // shards starting at or past the end of the data, plus the final bound
      while (next_shard <= nshards) out_bounds[next_shard++] = fsize;
    }
  }
  close(fd);
  return 0;
}

}  // extern "C"

namespace {

long csv_parse_span(int fd, long data_start, long fsize, char delim,
                    int nthreads, float** out_data, long* out_rows) {
  long span = fsize - data_start;
  if (nthreads < 1) nthreads = 1;
  if (span < (1 << 20)) nthreads = 1;  // small file: one thread

  std::vector<std::vector<float>> parts(nthreads);
  std::vector<long> rows(nthreads, 0);
  std::vector<long> cols(nthreads, -1);
  std::vector<bool> ragged(nthreads, false);
  std::vector<Range> ranges(nthreads);
  long per = span / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    long s = data_start + t * per;
    long e = (t == nthreads - 1) ? fsize : data_start + (t + 1) * per;
    ranges[t] = align_to_lines(fd, s, e, fsize);
  }

  std::vector<std::thread> workers;
  for (int t = 0; t < nthreads; ++t) {
    workers.emplace_back([&, t]() {
      Range r = ranges[t];
      long n = r.end - r.start;
      if (n <= 0) return;
      std::vector<char> buf(n + 1);
      long off = 0;
      while (off < n) {
        ssize_t got = pread(fd, buf.data() + off, n - off, r.start + off);
        if (got <= 0) break;
        off += got;
      }
      buf[off] = '\0';
      parts[t].reserve(off / 4);
      bool rg = false;
      parse_chunk(buf.data(), off, delim, &parts[t], &rows[t], &cols[t], &rg);
      ragged[t] = rg;
    });
  }
  for (auto& w : workers) w.join();

  // uniform column count across every chunk, else signal ragged (-2)
  long ncols = -1;
  for (int t = 0; t < nthreads; ++t) {
    if (ragged[t]) return -2;
    if (rows[t] == 0) continue;
    if (ncols < 0) ncols = cols[t];
    if (cols[t] != ncols) return -2;
  }

  long total = 0, trows = 0;
  for (int t = 0; t < nthreads; ++t) {
    total += (long)parts[t].size();
    trows += rows[t];
  }
  float* data = (float*)malloc(total * sizeof(float));
  if (!data) return -1;
  long pos = 0;
  for (int t = 0; t < nthreads; ++t) {
    memcpy(data + pos, parts[t].data(), parts[t].size() * sizeof(float));
    pos += (long)parts[t].size();
  }
  *out_data = data;
  *out_rows = trows;
  return total;
}

}  // namespace

extern "C" {

// Multi-threaded chunked binary read into caller buffer.
long ht_read_bytes(const char* path, long offset, long size, void* buf,
                   int nthreads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  if (nthreads < 1) nthreads = 1;
  if (size < (8 << 20)) nthreads = 1;
  long per = size / nthreads;
  std::vector<std::thread> workers;
  std::vector<long> got(nthreads, 0);
  for (int t = 0; t < nthreads; ++t) {
    workers.emplace_back([&, t]() {
      long s = t * per;
      long e = (t == nthreads - 1) ? size : (t + 1) * per;
      long off = s;
      while (off < e) {
        ssize_t r = pread(fd, (char*)buf + off, e - off, offset + off);
        if (r <= 0) break;
        off += r;
      }
      got[t] = off - s;
    });
  }
  for (auto& w : workers) w.join();
  close(fd);
  long total = 0;
  for (long g : got) total += g;
  return total;
}

void ht_free(void* p) { free(p); }

}  // extern "C"
