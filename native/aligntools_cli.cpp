// Native single-pair CLI: the cold-start fast path of the `aligntools`
// surface (the 7th engine implementation, differentially tested like the
// other six).
//
// Rationale: the Python CLI's spec-routed single-pair path costs ~0.4 s
// cold (interpreter + numpy import); the reference C binary answers in
// ~10 ms. This binary closes that last gap: the Python console script
// exec()s it for the five single-pair subcommands when it is built
// (cli.py _maybe_exec_native), and its stdout/stderr surface is
// byte-identical to both the Python CLI and the reference binary
// (tests/test_native_cli.py).
//
// Semantics source of truth: aligntools_tpu/spec/engine.py (the NumPy
// oracle), which documents every reference quirk with alignment.h line
// citations. This file implements the same recurrences scalar-style in
// doubles (the reference also computes in double), emits the packed
// 1-byte/cell pointer layout of engine/scan.py, and walks it with the
// SAME at_traceback_* walkers the device engines use
// (aligntools_native.cpp) — one walker, four callers.
//
// Build: make -C native aligntools_cli   (compiled with
// aligntools_native.cpp for the parser + walkers; -lz).

#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <unistd.h>  // POSIX getopt

#ifndef ALIGNTOOLS_VERSION
#define ALIGNTOOLS_VERSION "0.1.0"
#endif

// ---- C API of aligntools_native.cpp (same binary) ----
extern "C" {
void* at_parse(const char* path, int64_t max_records);
int at_parse_error(void* h);
int64_t at_num_records(void* h);
const uint8_t* at_arena(void* h);
const int64_t* at_records_meta(void* h);
void at_free(void* h);
int64_t at_traceback_affine(const uint8_t* ptrs, int64_t row_stride,
                            const uint8_t* q, int64_t m, const uint8_t* t,
                            int64_t n, int start_state, int64_t i, int64_t j,
                            int stop_at_j0, uint8_t* out1, uint8_t* out2);
int64_t at_traceback_overlap(const uint8_t* ptrs, int64_t row_stride,
                             const uint8_t* q, int64_t m, const uint8_t* t,
                             int64_t n, int64_t i, int64_t j, uint8_t* out1,
                             uint8_t* out2);
}

namespace {

constexpr double NEG = -INFINITY;

// Packed pointer byte layout (engine/scan.py:38-46, PK_* constants)
constexpr uint8_t PK_M_LOW = 0, PK_M_MID = 1, PK_M_UPP = 2, PK_M_JUMP = 3,
                  PK_M_HOME = 4, PK_M_UNSET = 7;
constexpr uint8_t PK_L_IS_MID = 1 << 3;
constexpr uint8_t PK_U_IS_UPP = 1 << 4;
constexpr uint8_t PK_J_IS_JUMP = 1 << 5;
constexpr uint8_t PK_OV_LEFT = 0, PK_OV_DIAG = 1, PK_OV_RIGHT = 2,
                  PK_OV_UNSET = 3;

// Walker start states (aligntools_native.cpp:195)
constexpr int ST_LOW = 0, ST_MID = 1, ST_UPP = 2;

struct Params {  // defaults: reference alignment.h:102-114 / params.py
  long m = 1, u = -2, o = -5, e = -1, j = -10;
};

[[noreturn]] void fatal(const std::string& msg) {
  std::fprintf(stderr, "FATAL ERROR: %s\n", msg.c_str());
  std::exit(255);  // the reference's die() -> exit(-1) (alignment.h:69-79)
}

// ---------------------------------------------------------------------------
// FASTA pair (kstring_read equivalent; io/fasta.py read_pair semantics)
// ---------------------------------------------------------------------------

struct Pair {
  std::vector<uint8_t> s1, s2;
  bool has_comment2 = false;
  std::vector<uint8_t> comment2;
};

Pair read_pair(const char* path) {
  void* h = at_parse(path, 3);  // 3: lets us detect a forbidden 3rd record
  if (at_parse_error(h)) {
    at_free(h);
    fatal(std::string("cannot open '") + path + "'");
  }
  int64_t nrec = at_num_records(h);
  if (nrec > 2) {
    at_free(h);
    fatal("input fasta file has more than 2 sequences");  // alignment.h:233
  }
  if (nrec < 2) {
    at_free(h);
    fatal("read_kstring: fail to read sequence");  // alignment.h:239
  }
  const uint8_t* arena = at_arena(h);
  const int64_t* meta = at_records_meta(h);  // 8 int64s per record
  Pair p;
  p.s1.assign(arena + meta[4], arena + meta[4] + meta[5]);
  p.s2.assign(arena + meta[8 + 4], arena + meta[8 + 4] + meta[8 + 5]);
  if (meta[8 + 2] >= 0) {  // comment_off of record 2
    p.has_comment2 = true;
    p.comment2.assign(arena + meta[8 + 2], arena + meta[8 + 2] + meta[8 + 3]);
  }
  at_free(h);
  return p;
}

// ksplit(tmp,'|') + atoi per non-empty field (alignment.h:250-253); C atoi
// IS the c_atoi the Python CLI uses.
std::vector<long> parse_junctions(const std::vector<uint8_t>& comment) {
  std::vector<long> sites;
  std::string tok;
  auto flush = [&] {
    if (!tok.empty()) sites.push_back(std::atol(tok.c_str()));
    tok.clear();
  };
  for (uint8_t c : comment) {
    if (c == '|') {
      flush();
    } else {
      tok.push_back(static_cast<char>(c));
    }
  }
  flush();
  return sites;
}

// ---------------------------------------------------------------------------
// DP fills. Scores in double (the reference's type); one packed pointer
// byte per cell in rows 1..m, row stride n+1; column 0 poisoned to
// PK_M_UNSET so a corrupt walk fails fast instead of looping (the
// reference's infinite-loop hazard, alignment.h:913-914).
// ---------------------------------------------------------------------------

struct FillOut {
  double score = NEG;
  int start_state = ST_MID;
  int stop_mode = 1;  // at_traceback_affine stop_at_j0 (2/1/0: see caller)
  int64_t i = 0, j = 0;  // traceback start cell
  std::vector<uint8_t> ptrs;  // m x (n+1)
};

// global (NW affine): spec_global / reference align_gla alignment.h:417-473
FillOut fill_global(const std::vector<uint8_t>& q,
                    const std::vector<uint8_t>& t, const Params& p) {
  const int64_t m = q.size(), n = t.size();
  const double o = p.o, e = p.e;
  FillOut out;
  out.ptrs.assign(static_cast<size_t>(m) * (n + 1), PK_M_UNSET);
  std::vector<double> Mp(n + 1), Lp(n + 1), Up(n + 1);
  std::vector<double> Mc(n + 1), Lc(n + 1), Uc(n + 1);
  // borders (alignment.h:428-441): M(0,0)=0, L(0,0)=U(0,0)=o;
  // row0: U(0,j)=o+e*j, M/L=-INF
  for (int64_t j = 0; j <= n; ++j) {
    Mp[j] = NEG;
    Lp[j] = NEG;
    Up[j] = o + e * static_cast<double>(j);
  }
  Mp[0] = 0.0;
  Lp[0] = o;
  for (int64_t i = 1; i <= m; ++i) {
    uint8_t* prow = out.ptrs.data() + (i - 1) * (n + 1);
    Mc[0] = NEG;
    Lc[0] = o + e * static_cast<double>(i);  // col0 L chain
    Uc[0] = NEG;                              // col0 U = -INF (u0)
    for (int64_t j = 1; j <= n; ++j) {
      const double sub = (q[i - 1] == t[j - 1]) ? double(p.m) : double(p.u);
      // M: max5 arg order L, M, U (alignment.h:451); strictly-greater
      // earliest-argument tie-break
      double best = Lp[j - 1];
      uint8_t code = PK_M_LOW;
      if (Mp[j - 1] > best) { best = Mp[j - 1]; code = PK_M_MID; }
      if (Up[j - 1] > best) { best = Up[j - 1]; code = PK_M_UPP; }
      Mc[j] = best + sub;
      uint8_t byte = (best > NEG) ? code : PK_M_UNSET;
      // L: max(L[i-1,j]+e, M[i-1,j]+o), tie -> LOW (alignment.h:456)
      const double la = Lp[j] + e, lb = Mp[j] + o;
      Lc[j] = la >= lb ? la : lb;
      if (lb > la) byte |= PK_L_IS_MID;
      // U (in-row): max(M[i,j-1]+o, U[i,j-1]+e), tie -> MID (:460)
      const double ua = Mc[j - 1] + o, ub = Uc[j - 1] + e;
      Uc[j] = ua >= ub ? ua : ub;
      if (ub > ua) byte |= PK_U_IS_UPP;
      prow[j] = byte;
    }
    Mp.swap(Mc);
    Lp.swap(Lc);
    Up.swap(Uc);
  }
  // final cell (m,n), tie order L, M, U (alignment.h:466-469)
  out.score = Lp[n];
  out.start_state = ST_LOW;
  if (Mp[n] > out.score) { out.score = Mp[n]; out.start_state = ST_MID; }
  if (Up[n] > out.score) { out.score = Up[n]; out.start_state = ST_UPP; }
  out.i = m;
  out.j = n;
  return out;
}

// local (SW affine): spec_local / reference align_local_affine :805-847
FillOut fill_local(const std::vector<uint8_t>& q,
                   const std::vector<uint8_t>& t, const Params& p) {
  const int64_t m = q.size(), n = t.size();
  const double o = p.o, e = p.e;
  FillOut out;
  out.ptrs.assign(static_cast<size_t>(m) * (n + 1), PK_M_UNSET);
  // NO border init — calloc-zero matrices (alignment.h:805-847)
  std::vector<double> Mp(n + 1, 0.0), Lp(n + 1, 0.0), Up(n + 1, 0.0);
  std::vector<double> Mc(n + 1), Lc(n + 1), Uc(n + 1);
  double best = NEG;
  out.i = out.j = 0;
  for (int64_t i = 1; i <= m; ++i) {
    uint8_t* prow = out.ptrs.data() + (i - 1) * (n + 1);
    Mc[0] = 0.0;
    Lc[0] = 0.0;
    Uc[0] = 0.0;  // u0 = 0 (calloc border)
    for (int64_t j = 1; j <= n; ++j) {
      const double sub = (q[i - 1] == t[j - 1]) ? double(p.m) : double(p.u);
      // arg order L+s, M+s, U+s, 0.0 (alignment.h:825) — the HOME
      // candidate is 0.0 WITHOUT +sub
      double mv = Lp[j - 1] + sub;
      uint8_t code = PK_M_LOW;
      if (Mp[j - 1] + sub > mv) { mv = Mp[j - 1] + sub; code = PK_M_MID; }
      if (Up[j - 1] + sub > mv) { mv = Up[j - 1] + sub; code = PK_M_UPP; }
      if (0.0 > mv) { mv = 0.0; code = PK_M_HOME; }
      Mc[j] = mv;
      uint8_t byte = code;  // 0.0 arg is always finite -> pointer always set
      // running argmax: strictly greater, row-major (alignment.h:830)
      if (mv > best) { best = mv; out.i = i; out.j = j; }
      const double la = Lp[j] + e, lb = Mp[j] + o;
      Lc[j] = la >= lb ? la : lb;
      if (lb > la) byte |= PK_L_IS_MID;
      const double ua = Mc[j - 1] + o, ub = Uc[j - 1] + e;
      Uc[j] = ua >= ub ? ua : ub;
      if (ub > ua) byte |= PK_U_IS_UPP;
      prow[j] = byte;
    }
    Mp.swap(Mc);
    Lp.swap(Lc);
    Up.swap(Uc);
  }
  out.score = best;
  out.start_state = ST_MID;  // trace_back_local_affine starts MID (:770)
  return out;
}

// fit (+ optional junction jump): spec_fit / align_fit_affine_jump :596-694
FillOut fill_fit(const std::vector<uint8_t>& q, const std::vector<uint8_t>& t,
                 const Params& p, const std::vector<long>* sites) {
  const int64_t m = q.size(), n = t.size();
  if (m > n) fatal("first sequence must be shorter than the second");  // :599
  if (m == 0) fatal("fit: empty query");
  const double o = p.o, e = p.e, jp = p.j;
  const bool use_jump = sites != nullptr;
  FillOut out;
  out.ptrs.assign(static_cast<size_t>(m) * (n + 1), PK_M_UNSET);
  // entry_mask[k]: jump ENTRY allowed at column j=k+1 iff target position
  // (j-1) is NOT a junction site — the reference's inverted enum-bool
  // gating (alignment.h:24/:659; spec/engine.py _jscan docstring)
  std::vector<uint8_t> entry(n, 1);
  if (use_jump) {
    for (long s : *sites) {
      if (s >= 0 && s < n) entry[static_cast<size_t>(s)] = 0;
    }
  }
  // borders (alignment.h:612-624): col0 all -INF; row0 M=U=0, L=J=-INF
  std::vector<double> Mp(n + 1, 0.0), Up(n + 1, 0.0);
  std::vector<double> Lp(n + 1, NEG), Jp(n + 1, NEG);
  std::vector<double> Mc(n + 1), Lc(n + 1), Uc(n + 1), Jc(n + 1);
  for (int64_t i = 1; i <= m; ++i) {
    uint8_t* prow = out.ptrs.data() + (i - 1) * (n + 1);
    Mc[0] = NEG;
    Lc[0] = NEG;
    Uc[0] = NEG;  // u0 = -INF
    Jc[0] = NEG;
    for (int64_t j = 1; j <= n; ++j) {
      const double sub = (q[i - 1] == t[j - 1]) ? double(p.m) : double(p.u);
      // M: arg order L,M,U[,J] (alignment.h:635 with -s, :641 without)
      double best = Lp[j - 1];
      uint8_t code = PK_M_LOW;
      if (Mp[j - 1] > best) { best = Mp[j - 1]; code = PK_M_MID; }
      if (Up[j - 1] > best) { best = Up[j - 1]; code = PK_M_UPP; }
      if (use_jump && Jp[j - 1] > best) { best = Jp[j - 1]; code = PK_M_JUMP; }
      Mc[j] = best + sub;
      uint8_t byte = (best > NEG) ? code : PK_M_UNSET;
      const double la = Lp[j] + e, lb = Mp[j] + o;
      Lc[j] = la >= lb ? la : lb;
      if (lb > la) byte |= PK_L_IS_MID;
      const double ua = Mc[j - 1] + o, ub = Uc[j - 1] + e;
      Uc[j] = ua >= ub ? ua : ub;
      if (ub > ua) byte |= PK_U_IS_UPP;
      if (use_jump) {
        // J (in-row): entry M[i,j-1]+jump at non-junction (j-1), free
        // carry at junction columns; ties -> MID (alignment.h:657-667)
        const double ja = entry[j - 1] ? Mc[j - 1] + jp : NEG;
        const double jb = Jc[j - 1];
        Jc[j] = ja >= jb ? ja : jb;
        if (!(ja > NEG && ja >= jb)) byte |= PK_J_IS_JUMP;
      }
      prow[j] = byte;
    }
    Mp.swap(Mc);
    Lp.swap(Lc);
    Up.swap(Uc);
    if (use_jump) Jp.swap(Jc);
  }
  // start scan (alignment.h:672-690): row m over j in [0, n-1] — LAST
  // COLUMN EXCLUDED; M first then L, strictly greater (M beats L on ties,
  // smallest j wins within each matrix)
  out.score = NEG;
  out.j = 0;
  out.start_state = ST_MID;
  for (int64_t j = 0; j < n; ++j) {
    if (Mp[j] > out.score) { out.score = Mp[j]; out.j = j; }
  }
  for (int64_t j = 0; j < n; ++j) {
    if (Lp[j] > out.score) {
      out.score = Lp[j];
      out.j = j;
      out.start_state = ST_LOW;
    }
  }
  if (out.score == NEG) fatal("fit: no finite traceback start (reference UB)");
  out.i = m;
  return out;
}

// overlap (single matrix, LINEAR gap o; -e parsed but dead,
// alignment.h:944): spec_overlap / align_overlap :926-964
FillOut fill_overlap(const std::vector<uint8_t>& q,
                     const std::vector<uint8_t>& t, const Params& p) {
  const int64_t m = q.size(), n = t.size();
  const double o = p.o;
  FillOut out;
  out.ptrs.assign(static_cast<size_t>(m) * (n + 1), PK_OV_UNSET);
  // init order matters (alignment.h:937-938): row0=-INF then col0=0,
  // so M(0,0)=0
  std::vector<double> Mp(n + 1, NEG), Mc(n + 1);
  Mp[0] = 0.0;
  for (int64_t i = 1; i <= m; ++i) {
    uint8_t* prow = out.ptrs.data() + (i - 1) * (n + 1);
    Mc[0] = 0.0;
    for (int64_t j = 1; j <= n; ++j) {
      const double sub = (q[i - 1] == t[j - 1]) ? double(p.m) : double(p.u);
      // arg order LEFT, DIAGONAL, RIGHT (alignment.h:944)
      const double a = Mc[j - 1] + o, b = Mp[j - 1] + sub, c = Mp[j] + o;
      double val = a;
      if (b > val) val = b;
      if (c > val) val = c;
      Mc[j] = val;
      uint8_t code;
      if (!(val > NEG)) {
        code = PK_OV_UNSET;
      } else if (a >= val) {
        code = PK_OV_LEFT;
      } else if (b >= val) {
        code = PK_OV_DIAG;
      } else {
        code = PK_OV_RIGHT;
      }
      prow[j] = code;
    }
    Mp.swap(Mc);
  }
  // start scan: row m, j in [0, n-1]; j=0's 0.0 border is a valid start
  // -> possibly empty alignment (alignment.h:950-959)
  out.score = 0.0;  // row[0] = 0.0
  out.j = 0;
  for (int64_t j = 1; j < n; ++j) {
    if (Mp[j] > out.score) { out.score = Mp[j]; out.j = j; }
  }
  out.i = m;
  return out;
}

// edit distance: spec_edit / edit_dist alignment.h:291-315 — min-DP,
// indel cost HARDCODED 1 (-o dead :306-309), match 0 / mismatch u
long fill_edit(const std::vector<uint8_t>& q, const std::vector<uint8_t>& t,
               const Params& p) {
  const int64_t m = q.size(), n = t.size();
  const double u = p.u;
  std::vector<double> prev(n + 1), row(n + 1);
  for (int64_t j = 0; j <= n; ++j) prev[j] = static_cast<double>(j);
  for (int64_t i = 1; i <= m; ++i) {
    row[0] = static_cast<double>(i);
    for (int64_t j = 1; j <= n; ++j) {
      const double sub = (q[i - 1] == t[j - 1]) ? 0.0 : u;
      double v = prev[j - 1] + sub;
      if (prev[j] + 1.0 < v) v = prev[j] + 1.0;
      if (row[j - 1] + 1.0 < v) v = row[j - 1] + 1.0;
      row[j] = v;
    }
    prev.swap(row);
  }
  return static_cast<long>(prev[n]);  // (int) truncation (alignment.h:312)
}

// ---------------------------------------------------------------------------
// CLI surface (byte-identical to aligntools_tpu/cli.py)
// ---------------------------------------------------------------------------

int usage() {
  std::fprintf(
      stderr,
      "\n"
      "Program: aligntools (batched pairwise sequence alignment)\n"
      "Version: %s\n\n"
      "Usage:   aligntools <command> [options] <target.fa>\n\n"
      "Command: global     global (Needleman-Wunsch) alignment, affine gap\n"
      "         local      local (Smith-Waterman) alignment, affine gap\n"
      "         fit        fit alignment, affine gap plus junction jump "
      "state\n"
      "         overlap    overlap alignment\n"
      "         edit       edit distance\n"
      "         batch      many-pair batched pipeline (TSV output)\n"
      "         serve      long-lived request loop (stdin/stdout)\n"
      "\n",
      ALIGNTOOLS_VERSION);
  return 1;
}

int sub_usage(const char* mode, const Params& p) {
  std::fprintf(stderr,
               "\n"
               "Usage:   aligntools %s [options] <target.fa>\n"
               "\n"
               "Options: -m INT   score for a match [%ld]\n"
               "         -u INT   mismatch penalty [%ld]\n"
               "         -o INT   gap open penalty [%ld]\n"
               "         -e INT   gap extension penalty [%ld]\n",
               mode, p.m, p.u, p.o, p.e);
  if (std::strcmp(mode, "fit") == 0) {
    std::fprintf(stderr,
                 "         -j INT   jump penalty [%ld]\n"
                 "         -s       junction sites from 2nd record's "
                 "comment\n",
                 p.j);
  }
  std::fprintf(stderr, "\n");
  return 1;
}

void print_rows(const std::vector<uint8_t>& q, const std::vector<uint8_t>& t,
                const FillOut& f, bool overlap_mode) {
  const int64_t m = q.size(), n = t.size();
  std::vector<uint8_t> r1(m + n + 1), r2(m + n + 1);
  int64_t len;
  if (overlap_mode) {
    len = at_traceback_overlap(f.ptrs.data(), n + 1, q.data(), m, t.data(), n,
                               f.i, f.j, r1.data(), r2.data());
    if (len < 0) fatal("overlap traceback hit unset pointer");
  } else {
    // stop_at_j0: 2 = global (walk + unconsumed-prefix padding),
    // 1 = local (walk only), 0 = fit (while i>0)
    int stop = f.stop_mode;
    len = at_traceback_affine(f.ptrs.data(), n + 1, q.data(), m, t.data(), n,
                              f.start_state, f.i, f.j, stop, r1.data(),
                              r2.data());
    if (len < 0) fatal("traceback hit unset pointer");
  }
  // walkers emit reversed; print reversed-in-place
  for (int64_t k = len - 1; k >= 0; --k) std::putchar(r1[k]);
  std::putchar('\n');
  for (int64_t k = len - 1; k >= 0; --k) std::putchar(r2[k]);
  std::putchar('\n');
}

}  // namespace

int main(int argc, char** argv) {
  if (std::getenv("ALIGNTOOLS_NATIVE_CLI_MARK")) {
    // test hook: lets tests/test_native_cli.py assert the exec fast
    // path actually ran (the surface is otherwise byte-identical)
    std::fprintf(stderr, "[native-cli]\n");
  }
  if (argc < 2) return usage();
  const std::string mode = argv[1];
  const bool known = mode == "global" || mode == "local" || mode == "fit" ||
                     mode == "overlap" || mode == "edit";
  if (!known) {
    if (mode == "batch" || mode == "serve" || mode == "calibrate") {
      std::fprintf(stderr,
                   "[main] '%s' requires the python CLI (this is the "
                   "single-pair fast binary)\n",
                   mode.c_str());
      return 1;
    }
    std::fprintf(stderr, "[main] unrecognized command '%s'\n", mode.c_str());
    return 1;
  }
  Params p;
  bool use_sites = false;
  // '+' stops at the first non-option, matching Python getopt / the
  // reference's POSIX parsing (options before the file argument)
  const char* optstr = (mode == "fit") ? "+m:u:o:e:j:s" : "+m:u:o:e:";
  optind = 2;
  int c;
  while ((c = getopt(argc, argv, optstr)) != -1) {
    switch (c) {
      case 'm': p.m = std::atol(optarg); break;
      case 'u': p.u = std::atol(optarg); break;
      case 'o': p.o = std::atol(optarg); break;
      case 'e': p.e = std::atol(optarg); break;
      case 'j': p.j = std::atol(optarg); break;
      case 's': use_sites = true; break;
      default:
        // getopt already printed its diagnostic; match the Python CLI's
        // exit code for unrecognized/odd options
        std::fprintf(stderr, "aligntools %s: option parse error\n",
                     mode.c_str());
        return 1;
    }
  }
  if (optind >= argc) return sub_usage(mode.c_str(), p);
  const char* path = argv[argc - 1];  // rest[-1], like the Python CLI

  Pair pr = read_pair(path);
  std::vector<long> sites;
  if (use_sites) {
    if (mode != "fit") fatal("junction sites are only meaningful in fit mode");
    if (!pr.has_comment2) fatal("fail to read junction sites");  // :244
    sites = parse_junctions(pr.comment2);
  }

  if (mode == "edit") {
    std::printf("edit_distance=%ld\n", fill_edit(pr.s1, pr.s2, p));
  } else if (mode == "overlap") {
    FillOut f = fill_overlap(pr.s1, pr.s2, p);
    std::printf("%f\n", f.score);  // bare %f, no prefix (alignment.h:1000)
    print_rows(pr.s1, pr.s2, f, true);
  } else {
    FillOut f;
    if (mode == "global") {
      f = fill_global(pr.s1, pr.s2, p);
      f.stop_mode = 2;
    } else if (mode == "local") {
      f = fill_local(pr.s1, pr.s2, p);
      f.stop_mode = 1;
    } else {
      f = fill_fit(pr.s1, pr.s2, p, use_sites ? &sites : nullptr);
      f.stop_mode = 0;
    }
    if (mode == "fit" && use_sites && pr.has_comment2) {
      // junction echo line (alignment.h:249)
      std::fwrite(pr.comment2.data(), 1, pr.comment2.size(), stdout);
      std::putchar('\n');
    }
    std::printf("score=%f\n", f.score);
    print_rows(pr.s1, pr.s2, f, false);
  }
  // success epilogue (main.c:49-55 shape, our version string)
  std::fprintf(stderr, "[main] Version: %s\n", ALIGNTOOLS_VERSION);
  std::fprintf(stderr, "[main] CMD:");
  for (int k = 0; k < argc; ++k) std::fprintf(stderr, " %s", argv[k]);
  std::fprintf(stderr, "\n");
  return 0;
}
