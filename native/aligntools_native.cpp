// Native host-side runtime for aligntools: FASTA/FASTQ ingest and
// packed-pointer traceback walks.
//
// The reference implements these in C (vendored klib: src/kseq.h streaming
// parser over gzread; src/alignment.h:372-412/558-592/766-800/896-922
// traceback walks over four int pointer matrices). This is a new C++
// implementation designed for the device engines' data layout: the parser
// fills one contiguous arena (zero-copy handoff to numpy via ctypes), and
// the traceback walks the engine's packed 1-byte-per-cell pointer tensor
// (bit layout: aligntools_tpu/engine/scan.py module docstring).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
// Build: make -C native   (links -lz for transparent gzip).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Buffered gz reader (gzopen also reads plain files), kseq-style.
// ---------------------------------------------------------------------------

class GzReader {
 public:
  explicit GzReader(const char* path) : f_(gzopen(path, "rb")) {}
  ~GzReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // Returns next byte or -1 on EOF.
  int getc() {
    if (pos_ >= len_) {
      if (eof_) return -1;
      len_ = gzread(f_, buf_, sizeof(buf_));
      pos_ = 0;
      if (len_ <= 0) {
        eof_ = true;
        return -1;
      }
    }
    return buf_[pos_++];
  }

  // Reads until delimiter ('\n'), appending to out (delim not included).
  // Returns false on EOF with nothing read.
  bool getline(std::vector<uint8_t>& out) {
    int c = getc();
    if (c < 0) return false;
    while (c >= 0 && c != '\n') {
      out.push_back(static_cast<uint8_t>(c));
      c = getc();
    }
    if (!out.empty() && out.back() == '\r') out.pop_back();
    return true;
  }

 private:
  gzFile f_;
  unsigned char buf_[1 << 16];
  int pos_ = 0, len_ = 0;
  bool eof_ = false;
};

bool is_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

struct RecordMeta {
  int64_t name_off, name_len;
  int64_t comment_off, comment_len;  // comment_off == -1: no comment
  int64_t seq_off, seq_len;
  int64_t qual_off, qual_len;  // qual_off == -1: FASTA (no quality)
};

struct ParseResult {
  std::vector<uint8_t> arena;
  std::vector<RecordMeta> records;
  int error = 0;  // 0 ok, 1 open failure
};

ParseResult* parse_file(const char* path, int64_t max_records) {
  auto* res = new ParseResult();
  GzReader rd(path);
  if (!rd.ok()) {
    res->error = 1;
    return res;
  }
  std::vector<uint8_t> line;
  // scan to the first record marker (kseq.h:194)
  bool have = false;
  while (rd.getline(line)) {
    if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
      have = true;
      break;
    }
    line.clear();
  }
  while (have) {
    if (max_records >= 0 &&
        static_cast<int64_t>(res->records.size()) >= max_records) {
      break;
    }
    bool fastq = line[0] == '@';
    RecordMeta m{};
    // header: name up to first isspace, comment = rest (kseq.h:200-201)
    size_t split = 1;
    while (split < line.size() && !is_space(line[split])) split++;
    m.name_off = static_cast<int64_t>(res->arena.size());
    m.name_len = static_cast<int64_t>(split - 1);
    res->arena.insert(res->arena.end(), line.begin() + 1, line.begin() + split);
    if (split < line.size()) {
      m.comment_off = static_cast<int64_t>(res->arena.size());
      m.comment_len = static_cast<int64_t>(line.size() - split - 1);
      res->arena.insert(res->arena.end(), line.begin() + split + 1, line.end());
    } else {
      m.comment_off = -1;
      m.comment_len = 0;
    }
    // sequence lines until the next record marker or '+'
    m.seq_off = static_cast<int64_t>(res->arena.size());
    line.clear();
    have = false;
    bool plus = false;
    while (rd.getline(line)) {
      if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
        have = true;
        break;
      }
      if (!line.empty() && line[0] == '+') {
        plus = true;
        break;
      }
      res->arena.insert(res->arena.end(), line.begin(), line.end());
      line.clear();
    }
    m.seq_len = static_cast<int64_t>(res->arena.size()) - m.seq_off;
    m.qual_off = -1;
    m.qual_len = 0;
    if (fastq && plus) {
      // quality until it reaches seq length (kseq.h:221-228)
      m.qual_off = static_cast<int64_t>(res->arena.size());
      int64_t got = 0;
      line.clear();
      have = false;
      while (got < m.seq_len && rd.getline(line)) {
        res->arena.insert(res->arena.end(), line.begin(), line.end());
        got += static_cast<int64_t>(line.size());
        line.clear();
      }
      m.qual_len = got;
      // next record marker
      line.clear();
      while (rd.getline(line)) {
        if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
          have = true;
          break;
        }
        line.clear();
      }
    } else if (plus) {
      // '+' in a FASTA record: treat like kseq (qual for a '>' record is
      // not expected; consume nothing special) — next marker scan
      line.clear();
      while (rd.getline(line)) {
        if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
          have = true;
          break;
        }
        line.clear();
      }
    }
    res->records.push_back(m);
  }
  return res;
}

// ---------------------------------------------------------------------------
// Packed-pointer traceback walks (bit layout: engine/scan.py docstring).
// ---------------------------------------------------------------------------

constexpr int PK_M_LOW = 0, PK_M_MID = 1, PK_M_UPP = 2, PK_M_JUMP = 3,
              PK_M_HOME = 4, PK_M_UNSET = 7;
constexpr int PK_L_IS_MID = 1 << 3;
constexpr int PK_U_IS_UPP = 1 << 4;
constexpr int PK_J_IS_JUMP = 1 << 5;
constexpr int OV_LEFT = 0, OV_DIAG = 1, OV_RIGHT = 2, OV_UNSET = 3;

constexpr int ST_LOW = 0, ST_MID = 1, ST_UPP = 2, ST_JUMP = 3, ST_HOME = -1,
              ST_ERR = -2;

int next_state(uint8_t byte, int state) {
  switch (state) {
    case ST_MID:
      switch (byte & 0x7) {
        case PK_M_LOW:
          return ST_LOW;
        case PK_M_MID:
          return ST_MID;
        case PK_M_UPP:
          return ST_UPP;
        case PK_M_JUMP:
          return ST_JUMP;
        case PK_M_HOME:
          return ST_HOME;
        default:
          return ST_ERR;  // PK_M_UNSET: reference would loop forever here
      }
    case ST_LOW:
      return (byte & PK_L_IS_MID) ? ST_MID : ST_LOW;
    case ST_UPP:
      return (byte & PK_U_IS_UPP) ? ST_UPP : ST_MID;
    case ST_JUMP:
      return (byte & PK_J_IS_JUMP) ? ST_JUMP : ST_MID;
  }
  return ST_ERR;
}

}  // namespace

extern "C" {

// ---- parser C API ----

void* at_parse(const char* path, int64_t max_records) {
  return parse_file(path, max_records);
}

int at_parse_error(void* h) { return static_cast<ParseResult*>(h)->error; }

int64_t at_num_records(void* h) {
  return static_cast<int64_t>(static_cast<ParseResult*>(h)->records.size());
}

const uint8_t* at_arena(void* h) {
  return static_cast<ParseResult*>(h)->arena.data();
}

int64_t at_arena_size(void* h) {
  return static_cast<int64_t>(static_cast<ParseResult*>(h)->arena.size());
}

// 8 int64 fields per record, layout of RecordMeta.
const int64_t* at_records_meta(void* h) {
  return reinterpret_cast<const int64_t*>(
      static_cast<ParseResult*>(h)->records.data());
}

void at_free(void* h) { delete static_cast<ParseResult*>(h); }

// ---- traceback C API ----
//
// ptrs: rows i=1..m at ptrs[(i-1)*row_stride + j] (engine emits rows 1..m_pad;
// callers pass the sliced per-pair matrix). out1/out2 must hold >= m+n bytes.
// Emits the walked rows REVERSED (walk order); caller reverses. Returns the
// emitted length, or -1 on an unset pointer (reference UB we fail fast on).

int64_t at_traceback_affine(const uint8_t* ptrs, int64_t row_stride,
                            const uint8_t* q, int64_t m, const uint8_t* t,
                            int64_t n, int start_state, int64_t i, int64_t j,
                            int stop_at_j0, uint8_t* out1, uint8_t* out2) {
  // stop_at_j0: 1 for global/local (while i>0 && j>0), 0 for fit (while i>0)
  int state = start_state;
  int64_t len = 0;
  while (i > 0 && (!stop_at_j0 || j > 0)) {
    uint8_t byte = ptrs[(i - 1) * row_stride + j];
    int nxt = next_state(byte, state);
    if (nxt == ST_ERR) return -1;
    switch (state) {
      case ST_LOW:
        --i;
        out1[len] = q[i];
        out2[len] = '-';
        break;
      case ST_MID:
        if (j <= 0) return -1;  // corrupt matrix: would read t[-1]
        --i;
        --j;
        out1[len] = q[i];
        out2[len] = t[j];
        break;
      case ST_UPP:
      case ST_JUMP:
        if (j <= 0) return -1;  // corrupt matrix: would read t[-1]
        --j;
        out1[len] = '-';
        out2[len] = t[j];
        break;
      default:
        return -1;
    }
    ++len;
    state = nxt;
    if (nxt == ST_HOME) break;  // local HOME stops AFTER emitting (see
                                // engine/traceback.py _walk)
  }
  if (stop_at_j0 == 2) {
    // global epilogue: pad the unconsumed prefixes (alignment.h:398-407)
    while (j > 0) {
      --j;
      out1[len] = '-';
      out2[len] = t[j];
      ++len;
    }
    while (i > 0) {
      --i;
      out1[len] = q[i];
      out2[len] = '-';
      ++len;
    }
  }
  return len;
}

int64_t at_traceback_overlap(const uint8_t* ptrs, int64_t row_stride,
                             const uint8_t* q, int64_t m, const uint8_t* t,
                             int64_t n, int64_t i, int64_t j, uint8_t* out1,
                             uint8_t* out2) {
  int64_t len = 0;
  while (j > 0) {
    if (i <= 0) return -1;
    int code = ptrs[(i - 1) * row_stride + j] & 0x3;
    switch (code) {
      case OV_LEFT:
        --j;
        out1[len] = '-';
        out2[len] = t[j];
        break;
      case OV_DIAG:
        --i;
        --j;
        out1[len] = q[i];
        out2[len] = t[j];
        break;
      case OV_RIGHT:
        --i;
        out1[len] = q[i];
        out2[len] = '-';
        break;
      default:
        return -1;  // reference infinite-loop hazard (alignment.h:913-914)
    }
    ++len;
  }
  return len;
}

}  // extern "C"
