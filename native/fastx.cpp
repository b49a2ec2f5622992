// Native FASTA/FASTQ parser: the hot host-side data path.
//
// The reference streams reads through Bifrost's FileParser (SURVEY.md §2.3)
// with ~1 MB/thread buffered chunks (Common.hpp:138). This is this
// framework's equivalent: a zlib-backed batch parser that decodes bases
// straight to 2-bit codes (A=0,C=1,G=2,T=3, other=4) so Python never touches
// per-base characters. Exposed via a plain C ABI for ctypes
// (ratatosk_tpu/io/native.py).
//
// Build: native/build.sh  ->  native/libfastx.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

struct Rec {
  std::string name, seq, qual;
  bool valid = false;
};

struct Parser {
  gzFile f = nullptr;
  int fmt = 0;  // 1 = fasta, 2 = fastq
  std::string pending_line;  // lookahead (fasta header)
  Rec pending_rec;           // record that didn't fit the last batch
  bool eof = false;

  bool getline(std::string* out) {
    out->clear();
    char buf[1 << 16];
    while (true) {
      if (gzgets(f, buf, sizeof(buf)) == nullptr) return !out->empty();
      size_t n = strlen(buf);
      if (n && buf[n - 1] == '\n') {
        out->append(buf, n - 1);
        if (!out->empty() && out->back() == '\r') out->pop_back();
        return true;
      }
      out->append(buf, n);
    }
  }

  // next record into *r; returns 1 ok, 0 eof, -1 malformed
  int next(Rec* r) {
    std::string line;
    if (fmt == 1) {
      if (pending_line.empty()) {
        if (!getline(&line)) return 0;
      } else {
        line.swap(pending_line);
        pending_line.clear();
      }
      if (line.empty() || line[0] != '>') return -1;
      r->name = line.substr(1, line.find_first_of(" \t") - 1);
      r->seq.clear();
      r->qual.clear();
      while (getline(&line)) {
        if (!line.empty() && line[0] == '>') {
          pending_line = line;
          break;
        }
        r->seq += line;
      }
      return 1;
    }
    do {
      if (!getline(&line)) return 0;
    } while (line.empty());
    if (line[0] != '@') return -1;
    r->name = line.substr(1, line.find_first_of(" \t") - 1);
    if (!getline(&r->seq)) return -1;
    if (!getline(&line)) return -1;  // '+'
    if (!getline(&r->qual)) return -1;
    if (r->qual.size() != r->seq.size()) return -1;
    return 1;
  }
};

uint8_t g_code[256];
bool g_init = false;

void init_tables() {
  if (g_init) return;
  memset(g_code, 4, sizeof(g_code));
  g_code['A'] = g_code['a'] = 0;
  g_code['C'] = g_code['c'] = 1;
  g_code['G'] = g_code['g'] = 2;
  g_code['T'] = g_code['t'] = 3;
  g_init = true;
}

}  // namespace

extern "C" {

void* fx_open(const char* path) {
  init_tables();
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  int c = gzgetc(f);
  if (c < 0) {
    gzclose(f);
    return nullptr;
  }
  gzungetc(c, f);
  Parser* p = new Parser();
  p->f = f;
  p->fmt = (c == '>') ? 1 : (c == '@') ? 2 : 0;
  if (p->fmt == 0) {
    gzclose(f);
    delete p;
    return nullptr;
  }
  return p;
}

// Fills up to max_records records:
//   seq_buf[seq_cap]    2-bit codes (0-4), records concatenated
//   qual_buf[seq_cap]   raw quality chars (0-filled for FASTA)
//   offs[max_records+1] record boundaries in seq_buf (offs[0] == 0)
//   name_buf[name_cap]  record names, NUL separated
// Returns #records (0 = EOF), -1 malformed input, -2 buffers too small for
// even one record. A record that does not fit is kept for the next call.
int64_t fx_next_batch(void* h, uint8_t* seq_buf, int64_t seq_cap,
                      char* qual_buf, int64_t* offs, char* name_buf,
                      int64_t name_cap, int32_t max_records) {
  Parser* p = static_cast<Parser*>(h);
  if (!p) return -1;
  int64_t nrec = 0, spos = 0, npos = 0;
  offs[0] = 0;
  while (nrec < max_records) {
    Rec r;
    if (p->pending_rec.valid) {
      r = std::move(p->pending_rec);
      p->pending_rec.valid = false;
    } else {
      if (p->eof) break;
      int rc = p->next(&r);
      if (rc == 0) {
        p->eof = true;
        break;
      }
      if (rc < 0) return -1;
    }
    if (spos + (int64_t)r.seq.size() > seq_cap ||
        npos + (int64_t)r.name.size() + 1 > name_cap) {
      r.valid = true;
      p->pending_rec = std::move(r);
      return nrec ? nrec : -2;
    }
    const char* s = r.seq.data();
    uint8_t* dst = seq_buf + spos;
    for (size_t i = 0; i < r.seq.size(); ++i) dst[i] = g_code[(uint8_t)s[i]];
    if (p->fmt == 2) {
      memcpy(qual_buf + spos, r.qual.data(), r.qual.size());
    } else {
      memset(qual_buf + spos, 0, r.seq.size());
    }
    spos += r.seq.size();
    memcpy(name_buf + npos, r.name.data(), r.name.size());
    npos += r.name.size();
    name_buf[npos++] = '\0';
    offs[++nrec] = spos;
  }
  return nrec;
}

void fx_close(void* h) {
  Parser* p = static_cast<Parser*>(h);
  if (p) {
    if (p->f) gzclose(p->f);
    delete p;
  }
}

int fx_format(void* h) {
  Parser* p = static_cast<Parser*>(h);
  return p ? p->fmt : 0;
}

}  // extern "C"
