// Native IO of relate_tpu_torch: the streaming .haps parser and the text
// .anc tree writer, loaded through ctypes by io/native.py, which builds
// this file with g++ at first use (no CUDA, no PyTorch header).
//
// The reference's data loading is C++ (gzip popen + fscanf,
// include/src/data.cpp:6-67,543-573); this parses a .haps or .haps.gz with
// zlib straight into numpy-owned buffers. The .anc writer formats the tree
// records on several threads (the Python formatter is the bottleneck when
// dumping 10^4-10^5 trees). Same role as relate_tpu/native/relate_io.cpp;
// unlike it, the parser keeps every field whole (the chromosome too) and
// reports a malformed row instead of skipping characters.
//
// zlib: the header where the system has it, else the six functions used
// here, declared as zlib.h declares them; io/native.py links libz.so.1.

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
extern "C" {
typedef struct gzFile_s* gzFile;
gzFile gzopen(const char* path, const char* mode);
int gzread(gzFile file, void* buf, unsigned len);
char* gzgets(gzFile file, char* buf, int len);
int gzclose(gzFile file);
int gzbuffer(gzFile file, unsigned size);
int gzeof(gzFile file);
}
#endif

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Read one line (without its '\n') into *line; false at the end of the file.
bool read_line(gzFile f, std::string* line, std::vector<char>* buf) {
  line->clear();
  bool any = false;
  while (gzgets(f, buf->data(), (int)buf->size())) {
    any = true;
    size_t n = strlen(buf->data());
    if (n && (*buf)[n - 1] == '\n') {
      line->append(buf->data(), n - 1);
      return true;
    }
    line->append(buf->data(), n);
    if (gzeof(f)) return true;
  }
  return any;
}

bool blank(const std::string& s) {
  for (char c : s)
    if (!is_space(c)) return false;
  return true;
}

}  // namespace

extern "C" {

// Count the rows of a .haps (lines that are not blank) and the bytes of
// their first five fields, an upper bound of what rt_read_haps stores for
// the four text fields. Returns the rows, or -1 if the file does not open.
long rt_scan_haps(const char* path, long* field_bytes) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  gzbuffer(f, 1 << 20);
  std::vector<char> buf(1 << 16);
  long rows = 0, bytes = 0;
  int field = 0;
  bool in_field = false, content = false;
  int len;
  while ((len = gzread(f, buf.data(), (unsigned)buf.size())) > 0) {
    for (int i = 0; i < len; i++) {
      char c = buf[i];
      if (c == '\n') {
        rows += content;
        field = 0;
        in_field = content = false;
      } else if (is_space(c)) {
        if (in_field) field++;
        in_field = false;
      } else {
        in_field = content = true;
        if (field < 5) bytes++;
      }
    }
  }
  rows += content;
  gzclose(f);
  *field_bytes = bytes;
  return rows;
}

// Parse the rows of a .haps: "chr rsid bp ancestral alternative a_1 ... a_N"
// with every allele 0 or 1. Fills G (L*N uint8), bp (L int64) and text, the
// fields chr, rsid, ancestral and alternative of each row in turn, each
// followed by '\0' (at most text_cap bytes). Returns L, -1 if the file does
// not open, -2 if text_cap is too small, or -(3 + row) for a malformed row.
long rt_read_haps(const char* path, int N, long L, uint8_t* G, int64_t* bp,
                  char* text, long text_cap) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  gzbuffer(f, 1 << 20);
  std::vector<char> buf((size_t)2 * N + (1 << 16));
  std::string line;
  long row = 0, used = 0;
  while (row < L && read_line(f, &line, &buf)) {
    if (blank(line)) continue;
    const char* s = line.c_str();
    const char* field[5];
    size_t flen[5];
    for (int k = 0; k < 5; k++) {
      while (is_space(*s)) s++;
      field[k] = s;
      while (*s && !is_space(*s)) s++;
      flen[k] = (size_t)(s - field[k]);
      if (!flen[k]) { gzclose(f); return -3 - row; }
    }
    char* end = nullptr;
    bp[row] = strtoll(field[2], &end, 10);
    if (end != field[2] + flen[2]) { gzclose(f); return -3 - row; }
    uint8_t* g = G + (size_t)row * N;
    int k = 0;
    for (;;) {
      while (is_space(*s)) s++;
      if (!*s) break;
      if ((*s != '0' && *s != '1') || (s[1] && !is_space(s[1])) || k == N) {
        gzclose(f);
        return -3 - row;
      }
      g[k++] = (uint8_t)(*s - '0');
      s++;
    }
    if (k != N) { gzclose(f); return -3 - row; }
    const int keep[4] = {0, 1, 3, 4};
    for (int j : keep) {
      if (used + (long)flen[j] + 1 > text_cap) { gzclose(f); return -2; }
      memcpy(text + used, field[j], flen[j]);
      used += (long)flen[j];
      text[used++] = '\0';
    }
    row++;
  }
  gzclose(f);
  return row;
}

// Tree lines of a text .anc: per tree "pos: p:(%.5f %.3f sb se) ... \n"
// (anc.cpp:797-815 format). parents: (T*Mn) int32; bl: f64; ne: f32;
// sb/se: i32; pos: (T,) i32.
static void format_tree_range(long t0, long t1, int Mn, const int32_t* pos,
                              const int32_t* parents, const double* bl,
                              const float* ne, const int32_t* sb,
                              const int32_t* se, std::string* out) {
  out->reserve((size_t)(t1 - t0) * Mn * 40);
  char buf[128];
  for (long t = t0; t < t1; t++) {
    int n0 = snprintf(buf, sizeof buf, "%d: ", pos[t]);
    out->append(buf, n0);
    const int32_t* P = parents + (size_t)t * Mn;
    const double* B = bl + (size_t)t * Mn;
    const float* E = ne + (size_t)t * Mn;
    const int32_t* S0 = sb + (size_t)t * Mn;
    const int32_t* S1 = se + (size_t)t * Mn;
    for (int n = 0; n < Mn; n++) {
      int k = snprintf(buf, sizeof buf, "%d:(%.5f %.3f %d %d) ", P[n],
                       (double)B[n], (double)E[n], S0[n], S1[n]);
      out->append(buf, k);
    }
    out->push_back('\n');
  }
}

// Append the header and the T tree lines to path. Returns 0, -1 if the
// file does not open, -2 if a write failed.
int rt_write_anc_trees(const char* path, const char* header, long T, int Mn,
                       const int32_t* pos, const int32_t* parents,
                       const double* bl, const float* ne,
                       const int32_t* sb, const int32_t* se) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  int rc = 0;
  if (header && header[0] && fputs(header, f) < 0) rc = -2;
  // snprintf-format tree ranges in parallel (the float formatting is the
  // bottleneck at 10^4+ trees), then write the buffers in order
  unsigned hw = std::thread::hardware_concurrency();
  long nthreads = hw ? (long)hw : 4;
  if (nthreads > 8) nthreads = 8;
  if (nthreads > T) nthreads = T > 0 ? T : 1;
  std::vector<std::string> bufs((size_t)nthreads);
  std::vector<std::thread> threads;
  long per = (T + nthreads - 1) / nthreads;
  for (long i = 0; i < nthreads; i++) {
    long t0 = i * per, t1 = t0 + per < T ? t0 + per : T;
    if (t0 >= t1) break;
    threads.emplace_back(format_tree_range, t0, t1, Mn, pos, parents, bl,
                         ne, sb, se, &bufs[(size_t)i]);
  }
  for (auto& th : threads) th.join();
  for (auto& b : bufs)
    if (!b.empty() && fwrite(b.data(), 1, b.size(), f) != b.size()) rc = -2;
  if (fclose(f) != 0) rc = -2;
  return rc;
}

}  // extern "C"
