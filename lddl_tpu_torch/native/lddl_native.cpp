// Native preprocessing engine: sentence splitting + BERT normalization +
// memoized WordPiece, in one pass over UTF-8 document buffers.
//
// The port's own copy of lddl_tpu/native/lddl_native.cpp, unchanged
// below this comment (ABI version 8): the same exported functions, the
// same frozen CounterRNG / numpy-Philox replay contracts, so the two
// engines emit identical bytes. Names of the reference's Python modules in
// the comments below have counterparts of the same names in
// lddl_tpu_torch.
//
// Semantics contracts (held by tests/test_torch_native.py):
//  * sentence boundaries == preprocess.sentences.split_sentences
//  * token ids == HF BertTokenizerFast(vocab, do_lower_case)
//
// Unicode behavior is table-driven from unicode_tables.h, generated by
// gen_tables.py from Python's own unicodedata/re/str semantics and the
// installed HF tokenizers, and committed (see build.py).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <deque>
#include <limits>
#include <cmath>
#include <cstring>
#include <cstdlib>
#include <numeric>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include "unicode_tables.h"

namespace {

// SplitMix64 finalizer — the shared avalanche step of the chunked byte
// hash below and the CounterRNG further down (kept in sync by value, not
// by contract: the hash is internal to the probe tables and free to
// change; the CounterRNG constants are frozen cross-engine API).
inline uint64_t avalanche64(uint64_t z) {
  z ^= z >> 30;
  z *= 0xBF58476D1CE4E5B9ULL;
  z ^= z >> 27;
  z *= 0x94D049BB133111EBULL;
  z ^= z >> 31;
  return z;
}

inline uint16_t flags_of(uint32_t cp) {
  if (cp < 0x10000) return UFLAGS[cp];
  // Above the BMP: binary search the generated same-flag runs — exact for
  // the full Unicode range (astral Cf/Cc removal, punctuation, CJK
  // extensions, cased scripts), not a heuristic.
  constexpr size_t n = sizeof(AFLAG_START) / sizeof(AFLAG_START[0]);
  size_t lo = 0, hi = n;  // invariant: AFLAG_START[lo] <= cp (run 0 is
  while (hi - lo > 1) {   // 0x10000, the smallest possible input here)
    size_t mid = (lo + hi) / 2;
    if (AFLAG_START[mid] <= cp) lo = mid;
    else hi = mid;
  }
  return AFLAG_VALUE[lo];
}

// Append the folded (NFD-strip + lowercase) expansion of cp to out.
inline void fold_lower(uint32_t cp, std::vector<uint32_t>& out) {
  if (cp < 0x10000) {
    uint16_t idx = FOLD_IDX[cp];
    if (idx == 0xFFFF) {
      out.push_back(cp);
    } else {
      const uint32_t* e = &FOLD_OUT[3 * (size_t)idx];
      for (int i = 0; i < FOLD_N[idx]; ++i) out.push_back(e[i]);
    }
  } else {
    // Sparse astral folds (cased astral scripts like Deseret/Adlam).
    constexpr size_t n = sizeof(AFOLD_CP) / sizeof(AFOLD_CP[0]);
    size_t lo = 0, hi = n;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (AFOLD_CP[mid] < cp) lo = mid + 1;
      else hi = mid;
    }
    if (lo < n && AFOLD_CP[lo] == cp) {
      const uint32_t* e = &AFOLD_OUT[3 * lo];
      for (int i = 0; i < AFOLD_N[lo]; ++i) out.push_back(e[i]);
    } else {
      out.push_back(cp);
    }
  }
}

struct Utf8Doc {
  std::vector<uint32_t> cps;
  std::vector<int64_t> byte_off;  // cps.size()+1 offsets into the source
};

// Decode one document. ``need_off`` controls whether per-codepoint byte
// offsets are recorded: the tokenize path never consumes them, and
// skipping the int64-per-codepoint writes removes ~2/3 of the decoder's
// memory traffic (the BART sentence-range path still asks for them).
// Mostly-ASCII text takes the 8-bytes-at-a-time bulk scan.
void decode_utf8(const char* buf, int64_t start, int64_t end, Utf8Doc& doc,
                 bool need_off = true) {
  // Pre-size both vectors to the worst case (one codepoint per byte) and
  // write through raw pointers — no per-codepoint capacity checks.
  size_t cap = (size_t)(end - start);
  doc.cps.resize(cap);
  uint32_t* cp_out = doc.cps.data();
  int64_t* off_out = nullptr;
  if (need_off) {
    doc.byte_off.resize(cap + 1);
    off_out = doc.byte_off.data();
  }
  size_t k = 0;
  const unsigned char* p = (const unsigned char*)buf;
  int64_t i = start;
  while (i < end) {
#if defined(__SSE2__)
    // SIMD bulk-ASCII fast path: 16 bytes per probe, widened to uint32
    // lanes with three unpack stages — the byte->codepoint widening was
    // the decoder's inner loop (mostly-ASCII corpora take this for >95%
    // of bytes). x86-64 baseline guarantees SSE2; other ISAs take the
    // 8-byte scalar probe below.
    while (i + 16 <= end) {
      __m128i v = _mm_loadu_si128((const __m128i*)(p + i));
      if (_mm_movemask_epi8(v)) break;  // any high bit: leave SIMD path
      const __m128i zero = _mm_setzero_si128();
      __m128i lo16 = _mm_unpacklo_epi8(v, zero);
      __m128i hi16 = _mm_unpackhi_epi8(v, zero);
      _mm_storeu_si128((__m128i*)(cp_out + k),
                       _mm_unpacklo_epi16(lo16, zero));
      _mm_storeu_si128((__m128i*)(cp_out + k + 4),
                       _mm_unpackhi_epi16(lo16, zero));
      _mm_storeu_si128((__m128i*)(cp_out + k + 8),
                       _mm_unpacklo_epi16(hi16, zero));
      _mm_storeu_si128((__m128i*)(cp_out + k + 12),
                       _mm_unpackhi_epi16(hi16, zero));
      if (need_off) {
        for (int b = 0; b < 16; ++b) off_out[k + b] = i + b;
      }
      k += 16;
      i += 16;
    }
#endif
    // Bulk-ASCII fast path: copy 8 bytes per probe while the high bit is
    // clear everywhere.
    while (i + 8 <= end) {
      uint64_t w;
      memcpy(&w, p + i, 8);
      if (w & 0x8080808080808080ULL) break;
      for (int b = 0; b < 8; ++b) {
        if (need_off) off_out[k] = i + b;
        cp_out[k++] = p[i + b];
      }
      i += 8;
    }
    if (i >= end) break;
    if (need_off) off_out[k] = i;
    unsigned char c = p[i];
    if (c < 0x80) {
      cp_out[k++] = c;
      ++i;
      continue;
    }
    uint32_t cp;
    int n;
    if ((c >> 5) == 0x6) {
      cp = c & 0x1F;
      n = 2;
    } else if ((c >> 4) == 0xE) {
      cp = c & 0x0F;
      n = 3;
    } else if ((c >> 3) == 0x1E) {
      cp = c & 0x07;
      n = 4;
    } else {  // invalid byte: emit U+FFFD, advance one
      cp_out[k++] = 0xFFFD;
      ++i;
      continue;
    }
    if (i + n > end) {
      cp_out[k++] = 0xFFFD;
      ++i;
      continue;
    }
    bool ok = true;
    for (int b = 1; b < n; ++b) {
      unsigned char cc = p[i + b];
      if ((cc >> 6) != 0x2) {
        ok = false;
        break;
      }
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (!ok) {
      cp_out[k++] = 0xFFFD;
      ++i;
      continue;
    }
    cp_out[k++] = cp;
    i += n;
  }
  doc.cps.resize(k);
  if (need_off) {
    off_out[k] = end;
    doc.byte_off.resize(k + 1);
  }
}

void encode_utf8(uint32_t cp, std::string& out) {
  if (cp < 0x80) {
    out.push_back((char)cp);
  } else if (cp < 0x800) {
    out.push_back((char)(0xC0 | (cp >> 6)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back((char)(0xE0 | (cp >> 12)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (cp >> 18)));
    out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// ---------------------------------------------------------------------------
// Sentence splitter — exact port of lddl_tpu.preprocess.sentences.
// ---------------------------------------------------------------------------

inline bool is_close_quote(uint32_t cp) {
  return cp == '"' || cp == '\'' || cp == ')' || cp == ']' || cp == 0x201D ||
         cp == 0x2019;
}
inline bool is_open_quote(uint32_t cp) {
  return cp == '"' || cp == '\'' || cp == '(' || cp == '[' || cp == 0x201C ||
         cp == 0x2018;
}
inline bool is_terminator(uint32_t cp) {
  return cp == '.' || cp == '!' || cp == '?';
}
inline bool is_strip_quote(uint32_t cp) {  // the strip("\"'()[]“”‘’") set
  return cp == '"' || cp == '\'' || cp == '(' || cp == ')' || cp == '[' ||
         cp == ']' || cp == 0x201C || cp == 0x201D || cp == 0x2018 ||
         cp == 0x2019;
}

const char* const kAbbreviations[] = {
    "mr",   "mrs",  "ms",   "dr",   "prof", "sr",    "jr",   "st",   "lt",
    "col",  "gen",  "rep",  "sen",  "gov",  "capt",  "cmdr", "sgt",  "rev",
    "hon",  "pres", "supt", "det",  "insp", "vs",    "etc",  "al",   "eg",
    "ie",   "cf",   "ca",   "approx", "jan", "feb",  "mar",  "apr",  "jun",
    "jul",  "aug",  "sep",  "sept", "oct",  "nov",   "dec",  "mon",  "tue",
    "wed",  "thu",  "fri",  "sat",  "sun",  "no",    "vol",  "fig",  "eq",
    "sec",  "ch",   "pp",   "ed",   "eds",  "trans", "inc",  "ltd",  "corp",
    "co",   "dept", "univ", "assn", "bros", "a.m",   "p.m",  "u.s",  "u.k",
    "u.n",  "e.u",  "ph.d", "m.d",  "b.a",  "m.a",   "d.c"};

// Python: _looks_like_abbreviation(text[start : term_idx+1]).
// `cps[start..term]` inclusive of the terminator character.
bool looks_like_abbreviation(const std::vector<uint32_t>& cps, size_t start,
                             size_t term) {
  // last \S+ (re \s semantics)
  size_t end = term + 1;
  size_t w = end;
  while (w > start && !(flags_of(cps[w - 1]) & F_RE_SPACE)) --w;
  if (w == end) return false;  // cannot happen: terminator is non-space
  // core = word.rstrip(".").strip(quotes)
  size_t lo = w, hi = end;
  while (hi > lo && cps[hi - 1] == '.') --hi;
  while (hi > lo && is_strip_quote(cps[lo])) ++lo;
  while (hi > lo && is_strip_quote(cps[hi - 1])) --hi;
  if (hi == lo) return false;
  size_t n = hi - lo;
  if (n == 1 && (flags_of(cps[lo]) & F_ALPHA)) return true;
  // fullmatch (?:[A-Za-z]\.)+[A-Za-z]?
  {
    size_t i = lo;
    int pairs = 0;
    while (i + 1 < hi && ((cps[i] >= 'A' && cps[i] <= 'Z') ||
                          (cps[i] >= 'a' && cps[i] <= 'z')) &&
           cps[i + 1] == '.') {
      i += 2;
      ++pairs;
    }
    if (pairs > 0) {
      if (i == hi) return true;
      if (i + 1 == hi && ((cps[i] >= 'A' && cps[i] <= 'Z') ||
                          (cps[i] >= 'a' && cps[i] <= 'z')))
        return true;
    }
  }
  // core.lower() in abbreviations (set entries are ASCII; non-ASCII cores
  // can never match, so ASCII tolower is exact here). Longest entry is 6
  // bytes; a stack buffer + length-filtered scan beats a hashed lookup
  // that allocates a std::string per boundary candidate.
  if (n > 6) return false;
  char low[8];
  for (size_t i = lo; i < hi; ++i) {
    uint32_t c = cps[i];
    if (c >= 'A' && c <= 'Z') c += 32;
    if (c >= 0x80) return false;
    low[i - lo] = (char)c;
  }
  for (const char* a : kAbbreviations) {
    if (strlen(a) == n && memcmp(a, low, n) == 0) return true;
  }
  return false;
}

struct SentRange {
  size_t start, end;  // codepoint range, already stripped
};

// ---------------------------------------------------------------------------
// Learned punkt splitter: exact port of preprocess.sentences
// split_sentences_learned / _punkt_boundary over corpus-trained params
// (SplitterParams.serialize blob). Parity is fuzz-pinned by
// tests/test_native.py against the Python implementation.
// ---------------------------------------------------------------------------

// Append Python str.lower() of cp (full case mapping, may expand).
inline void py_lower(uint32_t cp, std::vector<uint32_t>& out) {
  if (cp < 0x10000) {
    uint16_t idx = LOWER_IDX[cp];
    if (idx == 0xFFFF) {
      out.push_back(cp);
    } else {
      const uint32_t* e = &LOWER_OUT[3 * (size_t)idx];
      for (int i = 0; i < LOWER_N[idx]; ++i) out.push_back(e[i]);
    }
  } else {
    constexpr size_t n = sizeof(ALOWER_CP) / sizeof(ALOWER_CP[0]);
    size_t lo = 0, hi = n;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (ALOWER_CP[mid] < cp) lo = mid + 1;
      else hi = mid;
    }
    if (lo < n && ALOWER_CP[lo] == cp) {
      const uint32_t* e = &ALOWER_OUT[3 * lo];
      for (int i = 0; i < ALOWER_N[lo]; ++i) out.push_back(e[i]);
    } else {
      out.push_back(cp);
    }
  }
}

struct PunktParams {
  std::unordered_map<std::string, int> abbrevs;   // set (value unused)
  std::unordered_map<std::string, int> collocs;   // "t1 t2" -> 1
  std::unordered_map<std::string, int> starters;
  std::unordered_map<std::string, int> ortho;

  static PunktParams* parse(const char* buf, int64_t len) {
    PunktParams* p = new PunktParams();
    int64_t i = 0;
    while (i < len) {
      int64_t j = i;
      while (j < len && buf[j] != '\n') ++j;
      if (j - i >= 2) {
        char tag = buf[i];
        std::string rest(buf + i + 2, (size_t)(j - i - 2));
        if (tag == 'A') {
          p->abbrevs[rest] = 1;
        } else if (tag == 'C') {
          p->collocs[rest] = 1;  // "t1 t2" exactly as serialized
        } else if (tag == 'S') {
          p->starters[rest] = 1;
        } else if (tag == 'O') {
          size_t sp = rest.rfind(' ');
          if (sp != std::string::npos)
            p->ortho[rest.substr(0, sp)] = atoi(rest.c_str() + sp + 1);
        }
      }
      i = j + 1;
    }
    return p;
  }
};

// punkt orthographic-context flags (must match preprocess.sentences).
constexpr int PK_ORTHO_BEG_UC = 1 << 1;
constexpr int PK_ORTHO_MID_UC = 1 << 2;
constexpr int PK_ORTHO_UNK_UC = 1 << 3;
constexpr int PK_ORTHO_BEG_LC = 1 << 4;
constexpr int PK_ORTHO_MID_LC = 1 << 5;
constexpr int PK_ORTHO_UNK_LC = 1 << 6;
constexpr int PK_ORTHO_UC =
    PK_ORTHO_BEG_UC | PK_ORTHO_MID_UC | PK_ORTHO_UNK_UC;
constexpr int PK_ORTHO_LC =
    PK_ORTHO_BEG_LC | PK_ORTHO_MID_LC | PK_ORTHO_UNK_LC;

// Python _NUM_TYPE: ^-?[\.,]?\d[\d,\.-]*\.?$ over the LOWERED codepoints.
bool punkt_is_number(const std::vector<uint32_t>& low) {
  size_t i = 0, n = low.size();
  if (i < n && low[i] == '-') ++i;
  if (i < n && (low[i] == '.' || low[i] == ',')) ++i;
  if (i >= n || !(flags_of(low[i]) & F_RE_DIGIT)) return false;
  ++i;
  for (; i < n; ++i) {
    uint32_t c = low[i];
    if (!((flags_of(c) & F_RE_DIGIT) || c == ',' || c == '.' || c == '-'))
      return false;
  }
  return true;
}

// str.lower() of a whole token. Per-codepoint table except CPython's one
// context-sensitive case, Final_Sigma: U+03A3 -> ς iff a cased char
// precedes it (skipping case-ignorables) and none follows.
void py_lower_token(const std::vector<uint32_t>& tok,
                    std::vector<uint32_t>& out) {
  for (size_t i = 0; i < tok.size(); ++i) {
    uint32_t cp = tok[i];
    if (cp == 0x3A3) {
      bool cased_before = false;
      for (size_t j = i; j > 0; --j) {
        uint16_t f = flags_of(tok[j - 1]);
        if (f & F_PY_CASE_IGNORABLE) continue;
        cased_before = (f & F_PY_CASED) != 0;
        break;
      }
      bool cased_after = false;
      for (size_t j = i + 1; j < tok.size(); ++j) {
        uint16_t f = flags_of(tok[j]);
        if (f & F_PY_CASE_IGNORABLE) continue;
        cased_after = (f & F_PY_CASED) != 0;
        break;
      }
      out.push_back(cased_before && !cased_after ? 0x3C2 : 0x3C3);
    } else {
      py_lower(cp, out);
    }
  }
}

// punkt type of a token: lowercase, numbers -> "##number##"; utf-8.
std::string punkt_type(const std::vector<uint32_t>& tok) {
  std::vector<uint32_t> low;
  low.reserve(tok.size());
  py_lower_token(tok, low);
  if (punkt_is_number(low)) return "##number##";
  std::string out;
  out.reserve(low.size());
  for (uint32_t cp : low) encode_utf8(cp, out);
  return out;
}

inline std::string strip_trailing_dot(const std::string& s) {
  if (!s.empty() && s.back() == '.') return s.substr(0, s.size() - 1);
  return s;
}

// tok[:1].isupper()/.islower() -> 'u' | 'l' | 'n'
inline char punkt_first_case(const std::vector<uint32_t>& tok) {
  if (tok.empty()) return 'n';
  uint16_t f = flags_of(tok[0]);
  if (f & F_UPPER) return 'u';
  if (f & F_LOWER) return 'l';
  return 'n';
}

inline bool punkt_is_punct_tok(const std::vector<uint32_t>& tok) {
  if (tok.size() != 1) return false;
  uint32_t c = tok[0];
  return c == ';' || c == ',' || c == ':' || c == '.' || c == '!'
      || c == '?';
}

// _ortho_heuristic: 1 = True, 0 = False, 2 = unknown.
int punkt_ortho_heuristic(const PunktParams& p,
                          const std::vector<uint32_t>& tok2,
                          const std::string& ty2_nosent) {
  if (punkt_is_punct_tok(tok2)) return 0;
  auto it = p.ortho.find(ty2_nosent);
  int ortho = it == p.ortho.end() ? 0 : it->second;
  char cse = punkt_first_case(tok2);
  if (cse == 'u' && (ortho & PK_ORTHO_LC) && !(ortho & PK_ORTHO_MID_UC))
    return 1;
  if (cse == 'l' && ((ortho & PK_ORTHO_UC) || !(ortho & PK_ORTHO_BEG_LC)))
    return 0;
  return 2;
}

bool punkt_boundary(const PunktParams& p, const std::vector<uint32_t>& w1,
                    const std::vector<uint32_t>& w2) {
  std::string ty1 = punkt_type(w1);
  std::string ty1_nop = strip_trailing_dot(ty1);
  // is_ellipsis: ^\.\.+$
  bool is_ellipsis = w1.size() >= 2;
  for (uint32_t c : w1)
    if (c != '.') { is_ellipsis = false; break; }
  // is_initial: ^[^\W\d]\.$  == re \w, not \d, then '.'
  bool is_initial =
      w1.size() == 2 && (flags_of(w1[0]) & F_RE_WORD)
      && !(flags_of(w1[0]) & F_RE_DIGIT) && w1[1] == '.';
  bool abbr = p.abbrevs.count(ty1_nop) != 0;
  if (!abbr) {
    size_t dash = ty1_nop.rfind('-');
    if (dash != std::string::npos)
      abbr = p.abbrevs.count(ty1_nop.substr(dash + 1)) != 0;
  }
  bool sentbreak = !(abbr || is_ellipsis);  // first pass
  if (w2.empty()) return sentbreak;
  std::string ty2 = punkt_type(w2);
  std::string ty2_nosent = strip_trailing_dot(ty2);
  if (p.collocs.count(ty1_nop + " " + ty2_nosent)) return false;  // 4.1.2
  if ((abbr || is_ellipsis) && !is_initial) {
    if (punkt_ortho_heuristic(p, w2, ty2_nosent) == 1) return true;
    if (punkt_first_case(w2) == 'u' && p.starters.count(ty2_nosent))
      return true;
    return sentbreak;
  }
  if (is_initial || ty1_nop == "##number##") {
    int oh = punkt_ortho_heuristic(p, w2, ty2_nosent);
    if (oh == 0) return false;
    if (oh == 2 && is_initial && punkt_first_case(w2) == 'u') {
      auto it = p.ortho.find(ty2_nosent);
      int ortho = it == p.ortho.end() ? 0 : it->second;
      if (!(ortho & PK_ORTHO_LC)) return false;
    }
  }
  return sentbreak;
}

// w1 rstrip set "\"')]}”’*" / w2 lstrip set "\"'([{“‘*"
inline bool punkt_w1_closer(uint32_t c) {
  return c == '"' || c == '\'' || c == ')' || c == ']' || c == '}'
      || c == 0x201D || c == 0x2019 || c == '*';
}
inline bool punkt_w2_opener(uint32_t c) {
  return c == '"' || c == '\'' || c == '(' || c == '[' || c == '{'
      || c == 0x201C || c == 0x2018 || c == '*';
}

// Python _punkt_word_before(text[start : i+1]) where cps[i] == '.':
// last \S+ run (always ends at i), rstrip closers, ensure trailing '.'.
void punkt_word_before(const std::vector<uint32_t>& cps, size_t start,
                       size_t i, std::vector<uint32_t>& w1) {
  w1.clear();
  size_t a = i + 1;
  while (a > start && !(flags_of(cps[a - 1]) & F_RE_SPACE)) --a;
  size_t e = i + 1;
  while (e > a && punkt_w1_closer(cps[e - 1])) --e;
  if (e == a) {  // all closers: Python's rstrip leaves "" -> "" + "."
    w1.push_back('.');
    return;
  }
  w1.assign(cps.begin() + a, cps.begin() + e);
  if (w1.back() != '.') w1.push_back('.');
}

// Python: _WORD_RUN.match(text, k); lstrip openers; if empty, raw.
void punkt_word_after(const std::vector<uint32_t>& cps, size_t k,
                      std::vector<uint32_t>& w2) {
  w2.clear();
  size_t n = cps.size();
  size_t e = k;
  while (e < n && !(flags_of(cps[e]) & F_RE_SPACE)) ++e;
  size_t b = k;
  while (b < e && punkt_w2_opener(cps[b])) ++b;
  if (b == e) b = k;  // fully stripped: fall back to the raw token
  w2.assign(cps.begin() + b, cps.begin() + e);
}

// Python: _ENUMERATOR_NEXT.match(text, k) — \d{1,3}\.[closers]*\s
// anchored at k. (\d = F_RE_DIGIT; no backtracking can save a 4+ digit
// run, because after fewer digits the next char is a digit, not '.'.)
bool enumerator_next(const std::vector<uint32_t>& cps, size_t k) {
  size_t n = cps.size();
  size_t p = k;
  int digits = 0;
  while (p < n && (flags_of(cps[p]) & F_RE_DIGIT) && digits <= 3) {
    ++p;
    ++digits;
  }
  if (digits < 1 || digits > 3) return false;
  if (p >= n || cps[p] != '.') return false;
  ++p;
  while (p < n && is_close_quote(cps[p])) ++p;
  return p < n && (flags_of(cps[p]) & F_RE_SPACE);
}

// Exact port of split_sentences(): emits stripped, non-empty ranges.
void split_sentences_cp(const std::vector<uint32_t>& cps,
                        std::vector<SentRange>& out,
                        const PunktParams* pk = nullptr) {
  out.clear();
  size_t n = cps.size();
  size_t start = 0;
  size_t i = 0;
  std::vector<uint32_t> w1, w2;  // learned-mode scratch
  while (i < n) {
    if (!is_terminator(cps[i])) {
      ++i;
      continue;
    }
    size_t j = i + 1;
    while (j < n && is_close_quote(cps[j])) ++j;
    size_t k = j;
    while (k < n && (flags_of(cps[k]) & F_RE_SPACE)) ++k;
    if (k == j || k == n) {  // \s+(?=\S) failed: regex resumes at i+1
      ++i;
      continue;
    }
    // The match succeeded. Learned mode (pk): every '.' candidate is
    // decided by the corpus-trained punkt procedure, ! and ? always
    // split (split_sentences_learned). Rule mode: a sentence may start
    // with anything but a lowercase letter (lowercase splits only after
    // ! / ?), a bare enumerator glues to the PRECEDING sentence, and
    // the abbreviation guard applies to '.' boundaries only.
    bool skip = false;
    if (pk != nullptr) {
      if (cps[i] == '.') {
        punkt_word_before(cps, start, i, w1);
        punkt_word_after(cps, k, w2);
        skip = !punkt_boundary(*pk, w1, w2);
      }
    } else if ((flags_of(cps[k]) & F_LOWER) && cps[i] == '.') {
      skip = true;
    } else if (enumerator_next(cps, k)) {
      skip = true;
    } else if (cps[i] == '.' && looks_like_abbreviation(cps, start, i)) {
      skip = true;
    }
    if (!skip) {
      // piece = text[start : j].strip()
      size_t lo = start, hi = j;
      while (lo < hi && (flags_of(cps[lo]) & F_STR_SPACE)) ++lo;
      while (hi > lo && (flags_of(cps[hi - 1]) & F_STR_SPACE)) --hi;
      if (hi > lo) out.push_back({lo, hi});
      start = k;
    }
    i = k;  // finditer resumes at m.end() whether or not we kept the piece
  }
  size_t lo = start, hi = n;
  while (lo < hi && (flags_of(cps[lo]) & F_STR_SPACE)) ++lo;
  while (hi > lo && (flags_of(cps[hi - 1]) & F_STR_SPACE)) --hi;
  if (hi > lo) out.push_back({lo, hi});
}

// ---------------------------------------------------------------------------
// WordPiece tokenizer with per-word memoization.
// ---------------------------------------------------------------------------

// Flat open-addressing word->ids memo: one probe array + two arenas, no
// per-entry heap nodes (the std::unordered_map version spent most of its
// time in node allocation + pointer chasing on this Zipf-hot lookup).
struct MemoTable {
  struct Slot {
    uint64_t hash = 0;
    uint32_t key_off = 0;
    uint32_t ids_off = 0;
    uint16_t key_len = 0;
    int16_t n_ids = -1;  // -1 = empty slot
  };
  std::vector<Slot> slots;
  std::string keys;             // key bytes arena
  std::vector<int32_t> ids;     // token-id arena
  size_t count = 0;
  size_t mask = 0;
  size_t cap = 0;  // clamped entry cap; bounds growth AND admission

  void init(size_t cap_entries) {
    // Clamp the cap to something allocatable: huge caps (the old lazy map
    // accepted any value as "effectively unbounded") degrade to 2^22
    // entries instead of aborting on bad_alloc or wrapping the size
    // computation.
    if (cap_entries > (1u << 22)) cap_entries = 1u << 22;
    cap = cap_entries;
    // Start SMALL and grow at <= 0.5 load (see grow()): pre-sizing for
    // the cap put every probe into a ~12 MB cold table — for a typical
    // corpus vocabulary the grown table fits in L2 and the Zipf-hot
    // lookup stops missing cache (measured ~25% of tokenize time).
    slots.assign(64, Slot());
    mask = slots.size() - 1;
    count = 0;
    keys.clear();
    ids.clear();
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot());
    mask = slots.size() - 1;
    for (const Slot& s : old) {
      if (s.n_ids < 0) continue;
      size_t i = s.hash & mask;
      while (slots[i].n_ids >= 0) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  static uint64_t hash_bytes(const char* p, size_t n) {
    // 8-byte-chunked SplitMix avalanche: one load+3 multiplies per 8
    // bytes instead of the old per-byte FNV-1a chain (8 serial
    // multiplies) — this hash sits on the Zipf-hot memo/vocab probe
    // path, once per word plus once per WordPiece munch probe. Purely
    // internal to the probe tables: no shard-byte contract.
    uint64_t h = 0x243F6A8885A308D3ULL ^ ((uint64_t)n * kGoldenHash);
    while (n >= 8) {
      uint64_t w;
      memcpy(&w, p, 8);
      h = avalanche64(h ^ w);
      p += 8;
      n -= 8;
    }
    if (n) {
      uint64_t w = 0;
      memcpy(&w, p, n);
      h = avalanche64(h ^ w);
    }
    return h | 1;  // never 0 (0 marks a never-used hash field)
  }
  static constexpr uint64_t kGoldenHash = 0x9E3779B97F4A7C15ULL;

  // Returns slot index; slot.n_ids >= 0 iff present.
  size_t find(const char* key, size_t len, uint64_t h) const {
    size_t i = h & mask;
    for (;;) {
      const Slot& s = slots[i];
      if (s.n_ids < 0) return i;  // empty: insertion point
      if (s.hash == h && s.key_len == len &&
          memcmp(keys.data() + s.key_off, key, len) == 0)
        return i;
      i = (i + 1) & mask;
    }
  }
};

// Flat bytes->id map (open addressing, arena keys) for the vocab: the
// WordPiece munch probes raw byte slices of the word directly — no
// "##"-prefixed scratch strings are ever built (continuation tokens live
// in their own table with the prefix stripped).
struct FlatIdMap {
  struct Slot {
    uint64_t hash = 0;
    uint32_t key_off = 0;
    uint16_t key_len = 0;
    int32_t id = -1;  // -1 = empty
  };
  std::vector<Slot> slots;
  std::string keys;
  size_t mask = 0;
  size_t count = 0;

  void init(size_t cap_entries) {
    size_t n = 64;
    while (n < cap_entries * 2) n <<= 1;
    slots.assign(n, Slot());
    mask = n - 1;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot());
    mask = slots.size() - 1;
    for (const Slot& s : old) {
      if (s.id < 0) continue;
      size_t i = s.hash & mask;
      while (slots[i].id >= 0) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  void insert(const char* key, size_t len, int32_t id) {
    if ((count + 1) * 2 > slots.size()) grow();
    uint64_t h = MemoTable::hash_bytes(key, len);
    size_t i = h & mask;
    while (slots[i].id >= 0) {
      if (slots[i].hash == h && slots[i].key_len == len &&
          memcmp(keys.data() + slots[i].key_off, key, len) == 0) {
        return;  // first mapping wins (matches unordered_map emplace)
      }
      i = (i + 1) & mask;
    }
    Slot& s = slots[i];
    s.hash = h;
    s.key_off = (uint32_t)keys.size();
    s.key_len = (uint16_t)len;
    s.id = id;
    keys.append(key, len);
    ++count;
  }

  int32_t find(const char* key, size_t len) const {
    uint64_t h = MemoTable::hash_bytes(key, len);
    size_t i = h & mask;
    for (;;) {
      const Slot& s = slots[i];
      if (s.id < 0) return -1;
      if (s.hash == h && s.key_len == len &&
          memcmp(keys.data() + s.key_off, key, len) == 0)
        return s.id;
      i = (i + 1) & mask;
    }
  }
};

// ---------------------------------------------------------------------------
// In-kernel thread pool. Threads are spawned per call (no persistent
// pool): bucket-scale work dwarfs spawn cost, and fork/spawn pool workers
// never inherit dangling native threads. Each worker writes only its own
// slice of the output and its own busy_ns slot, so no locks are needed.
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 64;

inline int clamp_threads(int64_t n, int64_t n_items) {
  if (n > kMaxThreads) n = kMaxThreads;
  if (n > n_items) n = n_items;
  return n < 1 ? 1 : (int)n;
}

// Run fn(t) for t in [0, nthreads), thread 0 on the calling thread. When
// busy_ns is non-null, each worker accumulates its wall time into
// busy_ns[t] (distinct slots — attribution can tell a starved pool from
// a serial floor).
template <typename Fn>
void run_parallel(int nthreads, int64_t* busy_ns, Fn&& fn) {
  auto timed = [busy_ns, &fn](int t) {
    if (busy_ns == nullptr) {
      fn(t);
      return;
    }
    auto t0 = std::chrono::steady_clock::now();
    fn(t);
    busy_ns[t] += std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  };
  if (nthreads <= 1) {
    timed(0);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve((size_t)(nthreads - 1));
  for (int t = 1; t < nthreads; ++t) workers.emplace_back(timed, t);
  timed(0);
  for (auto& w : workers) w.join();
}

// Mutable per-thread tokenizer state: the word/sentence memos and the
// per-sentence scratch (hoisted so the hot loop never allocates). The
// Tokenizer itself holds only read-only shared state (vocab tables,
// splitter params) once built, so one context per worker thread makes
// the whole tokenize pass data-race-free without any locking. Memo
// contents never affect output bytes (a miss recomputes identical ids),
// so per-thread memos cannot fork shard bytes.
struct TokContext {
  MemoTable memo;       // word -> WordPiece ids (persists across calls)
  MemoTable sent_memo;  // sentence cp-run -> ids (reset per call)
  std::string s_word;
  std::vector<uint32_t> s_cp_off, s_folded;
};

struct Tokenizer {
  FlatIdMap plain;  // tokens without the "##" prefix
  FlatIdMap cont;   // "##"-tokens, prefix stripped
  // Long-lived pool workers on heavy-tailed corpora (OpenWebText-scale
  // unique words) would otherwise grow the memo without bound; beyond the
  // cap, words are recomputed (identical result, no correctness impact).
  size_t memo_cap = 1u << 18;  // ~256k entries, tens of MB per worker
  int32_t unk_id = 0;
  bool lower = true;
  int32_t max_chars_per_word = 100;
  PunktParams* splitter = nullptr;  // owned; learned-mode sentence splits
  int32_t nthreads = 1;             // worker threads per kernel call
  int64_t busy_ns[kMaxThreads] = {};  // cumulative per-tid busy time
  std::deque<TokContext> ctxs;        // one per worker thread, lazily grown

  void ensure_ctxs(int n) {
    while ((int)ctxs.size() < n) {
      ctxs.emplace_back();
      ctxs.back().memo.init(memo_cap);
    }
  }
};

// WordPiece max-munch over one normalized word (utf8 + per-cp byte offsets).
void wordpiece(const Tokenizer& tok, const std::string& word,
               const std::vector<uint32_t>& cp_off,
               std::vector<int32_t>& out) {
  size_t n_cps = cp_off.size() - 1;
  if ((int64_t)n_cps > tok.max_chars_per_word) {
    out.push_back(tok.unk_id);
    return;
  }
  size_t start = 0;
  size_t first = out.size();
  while (start < n_cps) {
    size_t end = n_cps;
    int32_t found = -1;
    const FlatIdMap& table = start > 0 ? tok.cont : tok.plain;
    while (end > start) {
      // Probe the raw byte slice directly: no scratch string, and
      // continuation tokens live prefix-stripped in their own table.
      found = table.find(word.data() + cp_off[start],
                         cp_off[end] - cp_off[start]);
      if (found >= 0) break;
      --end;
    }
    if (found < 0) {  // unsplittable word -> single UNK
      out.resize(first);
      out.push_back(tok.unk_id);
      return;
    }
    out.push_back(found);
    start = end;
  }
}

void tokenize_word_memo(const Tokenizer& tok, TokContext& ctx,
                        const std::string& word,
                        const std::vector<uint32_t>& cp_off,
                        std::vector<int32_t>& out) {
  MemoTable& memo = ctx.memo;
  uint64_t h = MemoTable::hash_bytes(word.data(), word.size());
  size_t slot = memo.find(word.data(), word.size(), h);
  if (memo.slots[slot].n_ids >= 0) {
    const MemoTable::Slot& s = memo.slots[slot];
    out.insert(out.end(), memo.ids.begin() + s.ids_off,
               memo.ids.begin() + s.ids_off + s.n_ids);
    return;
  }
  size_t first = out.size();
  wordpiece(tok, word, cp_off, out);
  size_t n_new = out.size() - first;
  // Admission: the CLAMPED cap (memo.cap, not the raw tok.memo_cap)
  // bounds growth, and the uint32 arena offsets must never wrap — a
  // word that would push either arena past 2^32 is recomputed instead
  // of cached (identical output, bounded memory).
  if (memo.count < memo.cap && word.size() <= 0xFFFF && n_new <= 0x7FFF &&
      memo.keys.size() + word.size() <= 0xFFFFFFFFull &&
      memo.ids.size() + n_new <= 0xFFFFFFFFull) {
    if ((memo.count + 1) * 2 > memo.slots.size()) {
      memo.grow();  // keeps load <= 0.5; invalidates the probed slot
      slot = memo.find(word.data(), word.size(), h);
    }
    MemoTable::Slot& s = memo.slots[slot];
    s.hash = h;
    s.key_off = (uint32_t)memo.keys.size();
    s.key_len = (uint16_t)word.size();
    s.ids_off = (uint32_t)memo.ids.size();
    s.n_ids = (int16_t)n_new;
    memo.keys.append(word);
    memo.ids.insert(memo.ids.end(), out.begin() + first, out.end());
    ++memo.count;
  }
}

// Precomputed ASCII dispatch tables for the normalizer inner loop: one
// class byte replaces the flags_of chain per character, and plain word
// characters take a branch-free gobble loop below. Classes are computed
// from the SAME flag tables the general path reads (folding cannot move
// an ASCII char between classes: tolower maps A-Z to a-z, and letter vs
// punct vs space is case-stable), so semantics are identical.
struct AsciiTables {
  uint8_t cls[128];  // 0=word 1=whitespace 2=punct 3=drop(clean_text)
  AsciiTables() {
    for (uint32_t c = 0; c < 128; ++c) {
      uint16_t f = UFLAGS[c];
      if (c == 0 || (f & F_HF_CTRL)) cls[c] = 3;
      else if (f & F_HF_WS) cls[c] = 1;
      else if (f & F_HF_PUNCT) cls[c] = 2;
      else cls[c] = 0;
    }
  }
};

inline const AsciiTables& ascii_tables() {
  static const AsciiTables t;
  return t;
}

// Normalize + pre-tokenize + WordPiece one sentence (codepoint range).
// Mirrors BertNormalizer(clean_text, handle_chinese_chars, strip_accents=
// lowercase, lowercase) + BertPreTokenizer + WordPiece.
void tokenize_sentence(const Tokenizer& tok, TokContext& ctx,
                       const std::vector<uint32_t>& cps,
                       size_t lo, size_t hi, std::vector<int32_t>& out) {
  std::string& word = ctx.s_word;     // utf8 of the current word
  std::vector<uint32_t>& cp_off = ctx.s_cp_off;  // byte offsets + end
  std::vector<uint32_t>& folded = ctx.s_folded;
  word.clear();
  cp_off.clear();
  cp_off.push_back(0);
  auto flush = [&]() {
    if (!word.empty()) {
      tokenize_word_memo(tok, ctx, word, cp_off, out);
      word.clear();
      cp_off.clear();
      cp_off.push_back(0);
    }
  };
  for (size_t i = lo; i < hi; ++i) {
    uint32_t cp = cps[i];
    uint16_t f = flags_of(cp);
    if (cp == 0 || cp == 0xFFFD || (f & F_HF_CTRL)) continue;  // clean_text
    if (f & F_HF_WS) {  // whitespace -> word break
      flush();
      continue;
    }
    if (f & F_CJK) {  // chinese chars: isolated words (spaced before NFD,
      flush();        // so the fold still applies — e.g. U+F900 -> U+8C48)
      folded.clear();
      if (tok.lower)
        fold_lower(cp, folded);
      else
        folded.push_back(cp);
      for (uint32_t fc : folded) {
        encode_utf8(fc, word);
        cp_off.push_back((uint32_t)word.size());
      }
      if (!word.empty()) tokenize_word_memo(tok, ctx, word, cp_off, out);
      word.clear();
      cp_off.clear();
      cp_off.push_back(0);
      continue;
    }
    if (cp < 0x80) {
      // ASCII fast path: folding is at most tolower (no NFD expansions),
      // so skip the fold-table indirection and the folded buffer. Plain
      // word characters additionally gobble their whole run in one tight
      // loop (class-table dispatch, no flag chain per char) — the common
      // case for latin text is one iteration of the OUTER loop per word
      // instead of per character.
      const AsciiTables& at = ascii_tables();
      uint8_t cls = at.cls[cp];
      if (cls == 0) {
        bool lower = tok.lower;
        size_t j = i;
        do {
          uint32_t c2 = cps[j];
          word.push_back(
              (char)((lower && c2 >= 'A' && c2 <= 'Z') ? c2 + 32 : c2));
          cp_off.push_back((uint32_t)word.size());
          ++j;
        } while (j < hi && cps[j] < 0x80 && at.cls[cps[j]] == 0);
        i = j - 1;  // outer ++i lands on the first non-word char
        continue;
      }
      if (cls == 1) {  // whitespace -> word break
        flush();
        continue;
      }
      if (cls == 3) continue;  // clean_text drop
      // Punctuation: isolated single-char word.
      uint32_t fc = (tok.lower && cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
      flush();
      word.push_back((char)fc);
      cp_off.push_back((uint32_t)word.size());
      tokenize_word_memo(tok, ctx, word, cp_off, out);
      word.clear();
      cp_off.clear();
      cp_off.push_back(0);
      continue;
    }
    folded.clear();
    if (tok.lower)
      fold_lower(cp, folded);
    else
      folded.push_back(cp);
    for (uint32_t fc : folded) {
      uint16_t ff = flags_of(fc);
      if (ff & F_HF_PUNCT) {  // punctuation: isolated single-cp word
        flush();
        encode_utf8(fc, word);
        cp_off.push_back((uint32_t)word.size());
        tokenize_word_memo(tok, ctx, word, cp_off, out);
        word.clear();
        cp_off.clear();
        cp_off.push_back(0);
      } else {
        encode_utf8(fc, word);
        cp_off.push_back((uint32_t)word.size());
      }
    }
  }
  flush();
}

// Split + tokenize documents given as (start, end) byte ranges of one
// buffer — the shared core of lddl_tok_docs (contiguous ranges) and the
// fused lddl_bert_instances (arbitrary ranges, e.g. a shuffled zero-copy
// spool view). Appends into the output vectors.
void tokenize_docs_impl(const Tokenizer& tok, TokContext& ctx,
                        const char* buf,
                        const int64_t* starts, const int64_t* ends,
                        int64_t n_docs, std::vector<int32_t>& ids,
                        std::vector<int32_t>& sent_lens,
                        std::vector<int32_t>& doc_counts) {
  ids.reserve(1 << 20);
  doc_counts.reserve((size_t)n_docs);
  Utf8Doc doc;
  std::vector<SentRange> sents;
  // Sentence-level token-run memo: repeated sentences within one call
  // (boilerplate, templated docs) skip the whole normalize+WordPiece pass.
  // Keyed on the raw codepoint run (exact memcmp, no collision risk);
  // tokenize_sentence is a pure function of (cps slice, tok config), so a
  // hit appends byte-identical ids. Reset per call: cross-bucket repeats
  // are rare and the 4-bytes-per-cp key arena should not outlive the call.
  MemoTable& smemo = ctx.sent_memo;
  smemo.init(1u << 15);
  for (int64_t d = 0; d < n_docs; ++d) {
    decode_utf8(buf, starts[d], ends[d], doc, /*need_off=*/false);
    split_sentences_cp(doc.cps, sents, tok.splitter);
    int32_t kept = 0;
    for (const SentRange& s : sents) {
      const char* key = (const char*)(doc.cps.data() + s.start);
      size_t klen = (size_t)(s.end - s.start) * 4;
      uint64_t h = 0;
      size_t slot = 0;
      bool memoable = klen <= 0xFFFF;
      if (memoable) {
        h = MemoTable::hash_bytes(key, klen);
        slot = smemo.find(key, klen, h);
        const MemoTable::Slot& hit = smemo.slots[slot];
        if (hit.n_ids >= 0) {
          if (hit.n_ids > 0) {
            ids.insert(ids.end(), smemo.ids.begin() + hit.ids_off,
                       smemo.ids.begin() + hit.ids_off + hit.n_ids);
            sent_lens.push_back(hit.n_ids);
            ++kept;
          }
          continue;
        }
      }
      size_t before = ids.size();
      tokenize_sentence(tok, ctx, doc.cps, s.start, s.end, ids);
      size_t n = ids.size() - before;
      if (n > 0) {
        sent_lens.push_back((int32_t)n);
        ++kept;
      }
      // Admission mirrors the word memo's: bounded entry count, uint16
      // key length, int16 id count, no uint32 arena-offset wrap.
      if (memoable && smemo.count < smemo.cap && n <= 0x7FFF &&
          smemo.keys.size() + klen <= 0xFFFFFFFFull &&
          smemo.ids.size() + n <= 0xFFFFFFFFull) {
        if ((smemo.count + 1) * 2 > smemo.slots.size()) {
          smemo.grow();
          slot = smemo.find(key, klen, h);
        }
        MemoTable::Slot& sl = smemo.slots[slot];
        sl.hash = h;
        sl.key_off = (uint32_t)smemo.keys.size();
        sl.key_len = (uint16_t)klen;
        sl.ids_off = (uint32_t)smemo.ids.size();
        sl.n_ids = (int16_t)n;
        smemo.keys.append(key, klen);
        smemo.ids.insert(smemo.ids.end(), ids.begin() + before, ids.end());
        ++smemo.count;
      }
    }
    doc_counts.push_back(kept);
  }
}

// Per-thread tokenize output arena: contiguous document slices are
// tokenized independently (per-sentence output depends only on the
// sentence bytes, never on neighbors), then stitched in thread order —
// the concatenation IS the serial output, byte for byte.
struct TokShard {
  std::vector<int32_t> ids, sent_lens, doc_counts;
};

void tokenize_docs_parallel(Tokenizer& tok, const char* buf,
                            const int64_t* starts, const int64_t* ends,
                            int64_t n_docs, std::vector<TokShard>& shards) {
  int nt = clamp_threads(tok.nthreads, n_docs);
  tok.ensure_ctxs(nt);
  shards.assign((size_t)nt, TokShard());
  run_parallel(nt, tok.busy_ns, [&](int t) {
    int64_t lo = n_docs * t / nt, hi = n_docs * (t + 1) / nt;
    tokenize_docs_impl(tok, tok.ctxs[(size_t)t], buf, starts + lo,
                       ends + lo, hi - lo, shards[(size_t)t].ids,
                       shards[(size_t)t].sent_lens,
                       shards[(size_t)t].doc_counts);
  });
}

// ---------------------------------------------------------------------------
// numpy-Philox replay — bit-exact mirror of the draw stream
// np.random.Generator(np.random.Philox(key=<16-byte blake2b digest>))
// produces for ``.random()`` (doubles) and ``.integers(0, n, dtype=int64)``
// (32-bit-buffered Lemire bounded draws). This freezes numpy's observed
// behavior so the fused C++ masking emits the SAME bytes as the
// ops.masking numpy kernel on the same utils.rng.sample_rng stream
// (pinned empirically by tests/test_fused.py::test_philox_replay_parity).
//
// Philox4x64-10: counter block is incremented BEFORE each generation (the
// first block uses counter 1), outputs served in order [0..3]; doubles
// are (u64 >> 11) * 2^-53; bounded int64 draws with range < 2^32 consume
// 32-bit halves of fresh u64 draws (low half first) through Lemire's
// multiply-shift rejection.
// ---------------------------------------------------------------------------

struct NumpyPhilox {
  uint64_t key0, key1;
  uint64_t ctr = 0;
  uint64_t buf[4];
  int buf_pos = 4;
  uint32_t half = 0;
  bool has_half = false;

  NumpyPhilox(uint64_t k0, uint64_t k1) : key0(k0), key1(k1) {}

  void block() {
    uint64_t c0 = ctr, c1 = 0, c2 = 0, c3 = 0;
    uint64_t k0 = key0, k1 = key1;
    for (int r = 0; r < 10; ++r) {
      if (r) {
        k0 += 0x9E3779B97F4A7C15ULL;
        k1 += 0xBB67AE8584CAA73BULL;
      }
      __uint128_t p0 = (__uint128_t)0xD2E7470EE14C6C93ULL * c0;
      __uint128_t p1 = (__uint128_t)0xCA5A826395121157ULL * c2;
      uint64_t n0 = (uint64_t)(p1 >> 64) ^ c1 ^ k0;
      uint64_t n1 = (uint64_t)p1;
      uint64_t n2 = (uint64_t)(p0 >> 64) ^ c3 ^ k1;
      uint64_t n3 = (uint64_t)p0;
      c0 = n0;
      c1 = n1;
      c2 = n2;
      c3 = n3;
    }
    buf[0] = c0;
    buf[1] = c1;
    buf[2] = c2;
    buf[3] = c3;
  }

  uint64_t next64() {
    if (buf_pos == 4) {
      ++ctr;
      block();
      buf_pos = 0;
    }
    return buf[buf_pos++];
  }

  // Position the stream as if exactly k next64() draws had been consumed
  // from a fresh generator (and no 32-bit half is pending). This is what
  // lets the masking replay partition its fixed-consumption passes across
  // threads: each worker seeks its own view of the SAME stream to its
  // row range's first draw, so the draws every cell sees are identical to
  // the serial order. Counter blocks serve 4 draws each and are
  // incremented before generation (first block = counter 1).
  void seek_draws(uint64_t k) {
    has_half = false;
    if (k == 0) {
      ctr = 0;
      buf_pos = 4;
      return;
    }
    ctr = (k + 3) / 4;
    block();
    buf_pos = (int)((k - 1) % 4) + 1;
  }

  double next_double() {
    return (double)(next64() >> 11) * (1.0 / 9007199254740992.0);
  }

  uint32_t next32() {
    if (has_half) {
      has_half = false;
      return half;
    }
    uint64_t v = next64();
    half = (uint32_t)(v >> 32);
    has_half = true;
    return (uint32_t)v;
  }

  // numpy buffered_bounded_lemire_uint32: rng_excl = high bound
  // (exclusive), threshold = (2^32 - rng_excl) % rng_excl.
  uint64_t lemire32(uint64_t rng_excl, uint32_t threshold) {
    uint64_t m = (uint64_t)next32() * rng_excl;
    uint32_t leftover = (uint32_t)m;
    if (leftover < rng_excl) {
      while (leftover < threshold) {
        m = (uint64_t)next32() * rng_excl;
        leftover = (uint32_t)m;
      }
    }
    return m >> 32;
  }
};

// The three-pass numpy-Philox masking replay over a (virtual) padded
// [n, width] matrix — THE frozen draw-order contract
// (ops.masking.mask_batch_numpy), kept in exactly ONE place: both
// lddl_mask_batch (explicit candidate/id matrices) and the fused
// lddl_bert_instances_masked (candidate predicate computed on the fly
// from instance geometry) instantiate this template, so a contract fix
// can never fork shard bytes between the rungs. ``cand(r, c)`` /
// ``orig(r, c)`` supply the candidate predicate and original id per
// cell; ``selected``/``out_ids`` are n*width row-major (out_ids carries
// orig() wherever no replacement applies).
// ``g`` must be FRESH (no draws consumed): with nthreads > 1 the
// fixed-consumption passes 1-2 are row-partitioned — each worker seeks a
// private view of the stream to its rows' first draw offset (1 u64 per
// double, no 32-bit halves, so every cell's draw index is known a
// priori) and writes only its own rows. Pass 3 consumes a VARIABLE
// number of draws per cell (Lemire rejection), so it stays serial on
// ``g`` seeked past passes 1-2. Identical draws per cell in any
// partitioning == identical bytes.
template <typename CandFn, typename OrigFn>
void philox_mask_replay(NumpyPhilox& g, int64_t n, int64_t width,
                        const int64_t* num_to_predict, int32_t mask_id,
                        int64_t vocab_size, CandFn cand, OrigFn orig,
                        uint8_t* selected, int32_t* out_ids,
                        int nthreads = 1, int64_t* busy_ns = nullptr) {
  if (n == 0) return;
  int64_t max_ntp = 0;
  for (int64_t r = 0; r < n; ++r)
    if (num_to_predict[r] > max_ntp) max_ntp = num_to_predict[r];
  int64_t k_max = std::min(std::max(max_ntp, (int64_t)1), width);

  const double inf = std::numeric_limits<double>::infinity();
  std::vector<uint8_t> decision((size_t)(n * width), 0);

  int nt = clamp_threads(nthreads, n);
  run_parallel(nt, busy_ns, [&](int t) {
    int64_t r_lo = n * t / nt, r_hi = n * (t + 1) / nt;
    std::vector<double> row((size_t)width), scratch((size_t)width);

    // Pass 1: score draws -> per-row k-th-smallest threshold -> selected.
    NumpyPhilox gs(g.key0, g.key1);
    gs.seek_draws((uint64_t)(r_lo * width));
    for (int64_t r = r_lo; r < r_hi; ++r) {
      for (int64_t c = 0; c < width; ++c) {
        double s = gs.next_double();
        row[(size_t)c] = cand(r, c) ? s : inf;
      }
      int64_t ntp = num_to_predict[r];
      int64_t k = std::min(std::max(ntp, (int64_t)1), k_max);
      scratch = row;
      std::nth_element(scratch.begin(), scratch.begin() + (k - 1),
                       scratch.end());
      double thresh = scratch[(size_t)(k - 1)];
      uint8_t* sel = selected + r * width;
      for (int64_t c = 0; c < width; ++c)
        sel[c] = (ntp > 0 && cand(r, c) && row[(size_t)c] <= thresh) ? 1 : 0;
    }

    // Pass 2: action draws -> 80/10/10 decision per selected position.
    // Reads only this worker's own rows of ``selected``, so no barrier
    // between the passes is needed.
    NumpyPhilox ga(g.key0, g.key1);
    ga.seek_draws((uint64_t)(n * width + r_lo * width));
    for (int64_t r = r_lo; r < r_hi; ++r) {
      for (int64_t c = 0; c < width; ++c) {
        int64_t i = r * width + c;
        double a = ga.next_double();
        if (selected[(size_t)i]) {
          if (a < 0.8)
            decision[(size_t)i] = 1;  // [MASK]
          else if (a < 0.9)
            decision[(size_t)i] = 2;  // random vocab id
        }
        out_ids[i] = decision[(size_t)i] == 1 ? mask_id : orig(r, c);
      }
    }
  });

  // Pass 3: random ids are drawn for EVERY position (stream contract),
  // applied only at decision==2.
  g.seek_draws((uint64_t)(2 * n * width));
  uint64_t rng_excl = (uint64_t)vocab_size;
  uint32_t threshold = (uint32_t)((0x100000000ULL - rng_excl) % rng_excl);
  for (int64_t i = 0; i < n * width; ++i) {
    uint64_t rid = g.lemire32(rng_excl, threshold);
    if (decision[(size_t)i] == 2) out_ids[i] = (int32_t)rid;
  }
}

// ---------------------------------------------------------------------------
// Cross-engine counter RNG — mirror of the frozen SplitMix64 contract in
// lddl_tpu/utils/rng.py (CounterRNG / stream_key / stable_shuffle_perm).
// The Python engine is the reference implementation; both must emit
// bit-identical draw sequences (tests/test_native.py pins this).
// ---------------------------------------------------------------------------

constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kKeyInit = 0xA0761D6478BD642FULL;

inline uint64_t mix64(uint64_t z) {
  z ^= z >> 30;
  z *= 0xBF58476D1CE4E5B9ULL;
  z ^= z >> 27;
  z *= 0x94D049BB133111EBULL;
  z ^= z >> 31;
  return z;
}

struct CounterRNG {
  uint64_t key = 0;
  uint64_t i = 0;

  void seed(std::initializer_list<uint64_t> parts) {
    key = kKeyInit;
    for (uint64_t p : parts) key = mix64(key + p);
    i = 0;
  }
  uint64_t next() { return mix64(key + (++i) * kGolden); }
  double uniform() { return (double)(next() >> 11) * (1.0 / 9007199254740992.0); }
  int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
    return lo + (int64_t)(next() % (uint64_t)(hi - lo));
  }
};

// Permutation of [0, n): stable argsort of the stream's first n uniforms.
std::vector<int64_t> stable_shuffle_perm(uint64_t key, int64_t n) {
  std::vector<double> u((size_t)n);
  for (int64_t i = 0; i < n; ++i)
    u[(size_t)i] =
        (double)(mix64(key + (uint64_t)(i + 1) * kGolden) >> 11) *
        (1.0 / 9007199254740992.0);
  std::vector<int64_t> perm((size_t)n);
  std::iota(perm.begin(), perm.end(), 0);
  std::stable_sort(perm.begin(), perm.end(),
                   [&](int64_t a, int64_t b) { return u[a] < u[b]; });
  return perm;
}

constexpr uint64_t kPairTag = 0x1DD10004ULL;
constexpr uint64_t kPairShuffleTag = 0x1DD10005ULL;

// NSP pair creation over one tokenized bucket — exact port of the Python
// engine (lddl_tpu.preprocess.bert.pairs_from_documents /
// create_pairs_from_document): replays the identical CounterRNG draw
// sequence per (seed, bucket, pass, document) stream. Shared by the
// staged lddl_bert_pairs entry and the fused lddl_bert_instances.
//
// Thread partitioning: every per-document stream is keyed on the global
// FILTERED document index, and the random-next branch only READS other
// documents' sentences (never their rng state), so pair creation over a
// document slice is independent of who else is running — workers own
// contiguous document ranges for ALL duplicate passes, append into
// per-thread arenas (PairsShard), and the global pre-shuffle instance
// order (dup-major, document-minor) is reconstructed from per-(thread,
// dup) counts without copying any id payloads.

// One sentence's token run; points into a tokenize arena (per-thread
// TokShard or the caller's flat ids) — no concatenated copy is built.
struct Sent {
  const int32_t* p;
  int32_t len;
};

struct PairsShard {
  std::vector<int32_t> flat;      // [CLS] a [SEP] b [SEP], slice-local order
  std::vector<int32_t> a_lens_v;
  std::vector<uint8_t> rn_v;
  std::vector<std::pair<int64_t, int32_t>> inst_spans;  // (flat off, len)
  std::vector<int64_t> dup_counts;  // instances appended per dup pass
};

// Instance reference in GLOBAL pre-shuffle order: the stitch output.
// Payload stays in the owning shard's flat arena.
struct InstRef {
  const int32_t* p;  // [CLS] a [SEP] b [SEP]
  int32_t len;
  int32_t a_len;
  uint8_t rn;
};

// Documents with zero (non-empty) sentences are dropped, matching the
// Python reconstruction (_documents_from_texts_native). Appends, so the
// per-thread tokenize shards concatenate into the global document list.
void append_docs(const int32_t* ids, const int32_t* sent_lens,
                 const int32_t* doc_sent_counts, int64_t n_docs_in,
                 std::vector<std::vector<Sent>>& docs) {
  int64_t k = 0;
  const int32_t* p = ids;
  for (int64_t d = 0; d < n_docs_in; ++d) {
    int32_t cnt = doc_sent_counts[d];
    if (cnt > 0) {
      std::vector<Sent> doc((size_t)cnt);
      for (int32_t s = 0; s < cnt; ++s) {
        doc[(size_t)s] = {p, sent_lens[k]};
        p += sent_lens[k];
        ++k;
      }
      docs.push_back(std::move(doc));
    }
  }
}

void pairs_worker(const std::vector<std::vector<Sent>>& docs, int64_t d_lo,
                  int64_t d_hi, int32_t max_seq_length,
                  double short_seq_prob, int32_t duplicate_factor,
                  uint64_t seed, uint64_t bucket, int32_t cls_id,
                  int32_t sep_id, PairsShard& out) {
  int64_t n_docs = (int64_t)docs.size();
  std::vector<int32_t> tokens_a, tokens_b;
  std::vector<int64_t> chunk;  // sentence indices of the current chunk
  CounterRNG rng;

  int32_t max_num_tokens = max_seq_length - 3;
  for (int32_t dup = 0; dup < duplicate_factor; ++dup) {
    size_t before = out.inst_spans.size();
    for (int64_t d = d_lo; d < d_hi; ++d) {
      rng.seed({kPairTag, seed, bucket, (uint64_t)dup, (uint64_t)d});
      const auto& document = docs[(size_t)d];
      int64_t target = max_num_tokens;
      if (rng.uniform() < short_seq_prob)
        target = rng.randint(2, max_num_tokens + 1);

      chunk.clear();
      int64_t current_length = 0;
      int64_t i = 0;
      while (i < (int64_t)document.size()) {
        chunk.push_back(i);
        current_length += document[(size_t)i].len;
        if (i == (int64_t)document.size() - 1 || current_length >= target) {
          if (!chunk.empty()) {
            int64_t a_end = 1;
            if (chunk.size() >= 2)
              a_end = rng.randint(1, (int64_t)chunk.size());
            tokens_a.clear();
            for (int64_t j = 0; j < a_end; ++j) {
              const Sent& s = document[(size_t)chunk[(size_t)j]];
              tokens_a.insert(tokens_a.end(), s.p, s.p + s.len);
            }
            tokens_b.clear();
            bool is_random_next = false;
            if (chunk.size() == 1 || rng.uniform() < 0.5) {
              is_random_next = true;
              int64_t target_b = target - (int64_t)tokens_a.size();
              int64_t rd = d;
              if (n_docs > 1) {
                for (int t = 0; t < 10; ++t) {
                  int64_t cand = rng.randint(0, n_docs);
                  if (cand != d) {
                    rd = cand;
                    break;
                  }
                }
              }
              const auto& rdoc = docs[(size_t)rd];
              int64_t rstart = rng.randint(0, (int64_t)rdoc.size());
              for (int64_t j = rstart; j < (int64_t)rdoc.size(); ++j) {
                const Sent& s = rdoc[(size_t)j];
                tokens_b.insert(tokens_b.end(), s.p, s.p + s.len);
                if ((int64_t)tokens_b.size() >= target_b) break;
              }
              int64_t num_unused = (int64_t)chunk.size() - a_end;
              i -= num_unused;  // put back the unused tail of the chunk
            } else {
              for (int64_t j = a_end; j < (int64_t)chunk.size(); ++j) {
                const Sent& s = document[(size_t)chunk[(size_t)j]];
                tokens_b.insert(tokens_b.end(), s.p, s.p + s.len);
              }
            }
            // Truncation: one draw per removed token, tracked as
            // front/back counters (mirror of _truncate_seq_pair).
            int64_t la = (int64_t)tokens_a.size();
            int64_t lb = (int64_t)tokens_b.size();
            int64_t fa = 0, ba = 0, fb = 0, bb = 0;
            while (la + lb > max_num_tokens) {
              bool from_a = la > lb;
              if ((from_a ? la : lb) <= 1) {
                from_a = !from_a;
                if ((from_a ? la : lb) <= 1) break;
              }
              if (from_a) {
                --la;
                if (rng.uniform() < 0.5)
                  ++fa;
                else
                  ++ba;
              } else {
                --lb;
                if (rng.uniform() < 0.5)
                  ++fb;
                else
                  ++bb;
              }
            }
            int64_t a_lo = fa, a_hi = (int64_t)tokens_a.size() - ba;
            int64_t b_lo = fb, b_hi = (int64_t)tokens_b.size() - bb;
            int64_t la_f = a_hi - a_lo, lb_f = b_hi - b_lo;
            if (la_f >= 1 && lb_f >= 1) {
              int64_t off = (int64_t)out.flat.size();
              out.flat.push_back(cls_id);
              out.flat.insert(out.flat.end(), tokens_a.begin() + a_lo,
                              tokens_a.begin() + a_hi);
              out.flat.push_back(sep_id);
              out.flat.insert(out.flat.end(), tokens_b.begin() + b_lo,
                              tokens_b.begin() + b_hi);
              out.flat.push_back(sep_id);
              out.inst_spans.push_back({off, (int32_t)(la_f + lb_f + 3)});
              out.a_lens_v.push_back((int32_t)la_f);
              out.rn_v.push_back(is_random_next ? 1 : 0);
            }
          }
          chunk.clear();
          current_length = 0;
        }
        ++i;
      }
    }
    out.dup_counts.push_back((int64_t)(out.inst_spans.size() - before));
  }
}

// Reconstruct the GLOBAL pre-shuffle instance order (dup-major,
// document-minor — exactly the serial emission order) from per-thread
// shards: for each dup pass, thread 0's instances come first (it owns
// the lowest document range), then thread 1's, and so on. Shard arenas
// must be fully built (threads joined) before this runs.
std::vector<InstRef> stitch_pairs(const std::vector<PairsShard>& shards,
                                  int32_t duplicate_factor) {
  size_t total = 0;
  for (const PairsShard& s : shards) total += s.inst_spans.size();
  std::vector<InstRef> refs;
  refs.reserve(total);
  std::vector<size_t> cur(shards.size(), 0);
  for (int32_t dup = 0; dup < duplicate_factor; ++dup) {
    for (size_t t = 0; t < shards.size(); ++t) {
      const PairsShard& s = shards[t];
      int64_t cnt =
          dup < (int32_t)s.dup_counts.size() ? s.dup_counts[(size_t)dup] : 0;
      for (int64_t k = 0; k < cnt; ++k) {
        size_t i = cur[t]++;
        refs.push_back({s.flat.data() + s.inst_spans[i].first,
                        s.inst_spans[i].second, s.a_lens_v[i], s.rn_v[i]});
      }
    }
  }
  return refs;
}

// Pair creation over the whole (filtered) document list, partitioned
// across nthreads contiguous document slices. ``docs`` must be the FULL
// list: the random-next branch reads other documents by global index.
void run_pairs(const std::vector<std::vector<Sent>>& docs,
               int32_t max_seq_length, double short_seq_prob,
               int32_t duplicate_factor, uint64_t seed, uint64_t bucket,
               int32_t cls_id, int32_t sep_id, int nthreads,
               int64_t* busy_ns, std::vector<PairsShard>& shards,
               std::vector<InstRef>& refs) {
  int64_t n_docs = (int64_t)docs.size();
  int nt = clamp_threads(nthreads, n_docs);
  shards.assign((size_t)nt, PairsShard());
  run_parallel(nt, busy_ns, [&](int t) {
    int64_t lo = n_docs * t / nt, hi = n_docs * (t + 1) / nt;
    pairs_worker(docs, lo, hi, max_seq_length, short_seq_prob,
                 duplicate_factor, seed, bucket, cls_id, sep_id,
                 shards[(size_t)t]);
  });
  refs = stitch_pairs(shards, duplicate_factor);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* lddl_tok_create(const char* vocab_buf, int64_t vocab_len,
                      int32_t unk_id, int do_lower_case) {
  auto* tok = new Tokenizer();
  tok->unk_id = unk_id;
  tok->lower = do_lower_case != 0;
  tok->plain.init(1u << 15);
  tok->cont.init(1u << 15);
  tok->ensure_ctxs(1);
  // vocab_buf: '\n'-joined tokens in id order.
  int32_t id = 0;
  int64_t start = 0;
  for (int64_t i = 0; i <= vocab_len; ++i) {
    if (i == vocab_len || vocab_buf[i] == '\n') {
      int64_t len = i - start;
      if (len > 0 && len <= 0xFFFF) {
        const char* t = vocab_buf + start;
        if (len > 2 && t[0] == '#' && t[1] == '#') {
          tok->cont.insert(t + 2, (size_t)(len - 2), id);
          // ALSO register the raw "##..."-prefixed string as a word-start
          // token, matching HF's single-dict lookup: unreachable via the
          // pre-tokenizer (every '#' is isolated as punctuation), but if
          // wordpiece() is ever fed un-pre-tokenized words the two
          // engines must still agree.
          tok->plain.insert(t, (size_t)len, id);
        } else {
          tok->plain.insert(t, (size_t)len, id);
        }
      }
      ++id;
      start = i + 1;
    }
  }
  return tok;
}

void lddl_tok_free(void* h) {
  auto* tok = (Tokenizer*)h;
  delete tok->splitter;
  delete tok;
}

// Attach corpus-learned punkt splitter params (SplitterParams.serialize
// blob) to this tokenizer: lddl_tok_docs then uses the learned decision
// procedure instead of the static rules. NULL/empty blob clears.
void lddl_tok_set_splitter(void* h, const char* blob, int64_t len) {
  auto* tok = (Tokenizer*)h;
  delete tok->splitter;
  tok->splitter = (blob != nullptr && len > 0)
      ? PunktParams::parse(blob, len) : nullptr;
}

// Override the WordPiece memo entry cap (testing / memory tuning). The cap
// only bounds memory: uncached words recompute to identical ids.
void lddl_tok_set_memo_cap(void* h, int64_t cap) {
  auto* tok = (Tokenizer*)h;
  tok->memo_cap = cap < 0 ? 0 : (size_t)cap;
  // Re-size (and clear) every per-thread table so the new cap fits at
  // <= 0.5 load.
  for (TokContext& ctx : tok->ctxs) {
    ctx.memo = MemoTable();
    ctx.memo.init(tok->memo_cap);
  }
}

// Worker threads used by the fused/staged kernels on this handle
// (clamped to [1, 64]; further clamped per call to the item count).
// Per-thread memo contexts are created eagerly here — a serial point —
// so the parallel regions never mutate the context list.
void lddl_tok_set_threads(void* h, int32_t n) {
  auto* tok = (Tokenizer*)h;
  tok->nthreads = n < 1 ? 1 : (n > kMaxThreads ? kMaxThreads : n);
  tok->ensure_ctxs(tok->nthreads);
}

int32_t lddl_tok_get_threads(void* h) {
  return ((Tokenizer*)h)->nthreads;
}

// Copy cumulative per-tid busy nanoseconds into out (cap slots); returns
// the number of slots written. Callers diff successive reads to emit the
// native_thread_busy_seconds_total{tid} counter.
int32_t lddl_tok_thread_busy_ns(void* h, int64_t* out, int32_t cap) {
  auto* tok = (Tokenizer*)h;
  int32_t n = tok->nthreads;
  if (n > cap) n = cap;
  for (int32_t t = 0; t < n; ++t) out[t] = tok->busy_ns[t];
  return n;
}

// Space-joined token strings straight into Arrow buffers: for each row
// (row_lens[r] ids from flat_ids, row-major), writes its joined UTF-8
// bytes to out_data and the int32 value offsets to out_offsets
// (n_rows + 1 entries; out_offsets[0] = 0). The caller sizes out_data as
// sum(tok_lens[flat_ids]) + max(0, n_ids - n_nonempty_rows) computed in
// numpy. Pure memcpy loop — replaces the Python-side b"".join.
void lddl_join_tokens(const int32_t* flat_ids, int64_t n_ids,
                      const int64_t* row_lens, int64_t n_rows,
                      const char* blob, const int64_t* tok_starts,
                      const int64_t* tok_lens, char* out_data,
                      int32_t* out_offsets) {
  int64_t pos = 0;
  int64_t k = 0;
  out_offsets[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t m = row_lens[r];
    for (int64_t j = 0; j < m; ++j, ++k) {
      if (j > 0) out_data[pos++] = ' ';
      int32_t id = flat_ids[k];
      int64_t len = tok_lens[id];
      memcpy(out_data + pos, blob + tok_starts[id], (size_t)len);
      pos += len;
    }
    out_offsets[r + 1] = (int32_t)pos;
  }
  (void)n_ids;
}

struct TokResult {
  int32_t* ids;
  int64_t n_ids;
  int32_t* sent_lens;
  int64_t n_sents;
  int32_t* doc_sent_counts;
  int64_t n_docs;
};

// Split + tokenize n_docs UTF-8 documents (concatenated in buf, bounded by
// offsets[n_docs+1]). Sentences with zero tokens are dropped; documents
// keep their (possibly zero) sentence count.
TokResult* lddl_tok_docs(void* h, const char* buf, const int64_t* offsets,
                         int64_t n_docs) {
  auto* tok = (Tokenizer*)h;
  auto* res = new TokResult();
  // Contiguous packing is the stride-1 special case of (starts, ends).
  // Per-thread shards stitch in thread order: the same single copy into
  // the malloc'd output the serial path always paid.
  std::vector<TokShard> shards;
  tokenize_docs_parallel(*tok, buf, offsets, offsets + 1, n_docs, shards);
  size_t n_ids = 0, n_sents = 0;
  for (const TokShard& s : shards) {
    n_ids += s.ids.size();
    n_sents += s.sent_lens.size();
  }
  res->n_ids = (int64_t)n_ids;
  res->ids = (int32_t*)malloc(sizeof(int32_t) * n_ids);
  res->n_sents = (int64_t)n_sents;
  res->sent_lens = (int32_t*)malloc(sizeof(int32_t) * n_sents);
  res->n_docs = n_docs;
  res->doc_sent_counts = (int32_t*)malloc(sizeof(int32_t) * (size_t)n_docs);
  size_t pi = 0, ps = 0, pd = 0;
  for (const TokShard& s : shards) {
    memcpy(res->ids + pi, s.ids.data(), sizeof(int32_t) * s.ids.size());
    pi += s.ids.size();
    memcpy(res->sent_lens + ps, s.sent_lens.data(),
           sizeof(int32_t) * s.sent_lens.size());
    ps += s.sent_lens.size();
    memcpy(res->doc_sent_counts + pd, s.doc_counts.data(),
           sizeof(int32_t) * s.doc_counts.size());
    pd += s.doc_counts.size();
  }
  return res;
}

void lddl_tok_result_free(TokResult* r) {
  free(r->ids);
  free(r->sent_lens);
  free(r->doc_sent_counts);
  delete r;
}

struct SplitResult {
  int64_t* starts;  // byte offsets into buf
  int64_t* ends;
  int64_t n_sents;
  int32_t* doc_sent_counts;
  int64_t n_docs;
};

// Sentence-split only (BART path): byte ranges of stripped sentences.
// params_blob (nullable) selects the learned punkt splitter.
SplitResult* lddl_split_docs2(const char* buf, const int64_t* offsets,
                              int64_t n_docs, const char* params_blob,
                              int64_t params_len) {
  PunktParams* pk = (params_blob != nullptr && params_len > 0)
      ? PunktParams::parse(params_blob, params_len) : nullptr;
  auto* res = new SplitResult();
  std::vector<int64_t> starts, ends;
  std::vector<int32_t> doc_counts;
  Utf8Doc doc;
  std::vector<SentRange> sents;
  for (int64_t d = 0; d < n_docs; ++d) {
    decode_utf8(buf, offsets[d], offsets[d + 1], doc);
    split_sentences_cp(doc.cps, sents, pk);
    for (const SentRange& s : sents) {
      starts.push_back(doc.byte_off[s.start]);
      ends.push_back(doc.byte_off[s.end]);
    }
    doc_counts.push_back((int32_t)sents.size());
  }
  delete pk;
  res->n_sents = (int64_t)starts.size();
  res->starts = (int64_t*)malloc(sizeof(int64_t) * starts.size());
  memcpy(res->starts, starts.data(), sizeof(int64_t) * starts.size());
  res->ends = (int64_t*)malloc(sizeof(int64_t) * ends.size());
  memcpy(res->ends, ends.data(), sizeof(int64_t) * ends.size());
  res->n_docs = n_docs;
  res->doc_sent_counts = (int32_t*)malloc(sizeof(int32_t) * n_docs);
  memcpy(res->doc_sent_counts, doc_counts.data(), sizeof(int32_t) * n_docs);
  return res;
}

SplitResult* lddl_split_docs(const char* buf, const int64_t* offsets,
                             int64_t n_docs) {
  return lddl_split_docs2(buf, offsets, n_docs, nullptr, 0);
}

void lddl_split_result_free(SplitResult* r) {
  free(r->starts);
  free(r->ends);
  free(r->doc_sent_counts);
  delete r;
}

struct PairResult {
  int32_t* seq_ids;  // flat [CLS] a [SEP] b [SEP], instances concatenated
  int64_t n_seq_ids;
  int32_t* seq_lens;
  int32_t* a_lens;
  uint8_t* is_random_next;
  int64_t n_instances;
};

// NSP pair creation over one bucket (staged entry: consumes lddl_tok_docs
// output directly). Applies the in-bucket shuffle and returns instances in
// flat array form (InstanceBatch). See bert_pairs_impl for the algorithm.
PairResult* lddl_bert_pairs(const int32_t* ids, const int32_t* sent_lens,
                            int64_t n_sents, const int32_t* doc_sent_counts,
                            int64_t n_docs_in, int32_t max_seq_length,
                            double short_seq_prob, int32_t duplicate_factor,
                            uint64_t seed, uint64_t bucket, int32_t cls_id,
                            int32_t sep_id, int32_t nthreads) {
  (void)n_sents;
  std::vector<std::vector<Sent>> docs;
  append_docs(ids, sent_lens, doc_sent_counts, n_docs_in, docs);
  std::vector<PairsShard> shards;
  std::vector<InstRef> refs;
  run_pairs(docs, max_seq_length, short_seq_prob, duplicate_factor, seed,
            bucket, cls_id, sep_id, nthreads, nullptr, shards, refs);

  // In-bucket shuffle (mirror of stable_shuffle_perm in utils/rng.py).
  int64_t n_inst = (int64_t)refs.size();
  CounterRNG kr;
  kr.seed({kPairShuffleTag, seed, bucket});
  std::vector<int64_t> perm = stable_shuffle_perm(kr.key, n_inst);

  int64_t total_ids = 0;
  for (const InstRef& rf : refs) total_ids += rf.len;
  auto* res = new PairResult();
  res->n_instances = n_inst;
  res->seq_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n_inst);
  res->a_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n_inst);
  res->is_random_next = (uint8_t*)malloc((size_t)n_inst);
  res->n_seq_ids = total_ids;
  res->seq_ids = (int32_t*)malloc(sizeof(int32_t) * (size_t)total_ids);
  int64_t pos = 0;
  for (int64_t r = 0; r < n_inst; ++r) {
    const InstRef& rf = refs[(size_t)perm[(size_t)r]];
    memcpy(res->seq_ids + pos, rf.p, sizeof(int32_t) * (size_t)rf.len);
    pos += rf.len;
    res->seq_lens[r] = rf.len;
    res->a_lens[r] = rf.a_len;
    res->is_random_next[r] = rf.rn;
  }
  return res;
}

void lddl_pairs_free(PairResult* r) {
  free(r->seq_ids);
  free(r->seq_lens);
  free(r->a_lens);
  free(r->is_random_next);
  delete r;
}

// Free ONLY the result struct — buffer ownership was transferred to the
// caller, which frees each array via lddl_buf_free when its (numpy)
// wrapper dies. The *_free variants remain for error paths.
void lddl_pairs_release(PairResult* r) { delete r; }
void lddl_tok_result_release(TokResult* r) { delete r; }
void lddl_buf_free(void* p) { free(p); }

struct InstResult {
  int32_t* seq_ids;  // flat [CLS] a [SEP] b [SEP], instances concatenated
  int64_t n_seq_ids;
  int32_t* seq_lens;
  int32_t* a_lens;
  uint8_t* is_random_next;
  int64_t n_instances;
  int32_t* a_ids;  // flat A segments row-major (want_ab only, else NULL)
  int64_t n_a_ids;
  int32_t* b_ids;  // flat B segments row-major (want_ab only, else NULL)
  int64_t n_b_ids;
};

// FUSED hot path: raw UTF-8 document ranges -> packed instance buffers in
// one native pass (sentence split + normalize + WordPiece + NSP pair
// creation + in-bucket shuffle), with no intermediate result structs or
// cross-boundary copies. (start, end) pairs may point anywhere into
// ``buf`` — a shuffled zero-copy spool view needs no repacking. With
// ``want_ab`` the kernel also emits the flat A/B id segments (row-major)
// so the schema-v2 column builders wrap them without re-gathering; the
// static-masking path derives A/B from the masked matrix instead and
// skips them. Output is bit-identical to the staged
// lddl_tok_docs + lddl_bert_pairs pipeline (same frozen CounterRNG
// streams; pinned by tests/test_fused.py).
InstResult* lddl_bert_instances(void* h, const char* buf,
                                const int64_t* starts, const int64_t* ends,
                                int64_t n_docs, int32_t max_seq_length,
                                double short_seq_prob,
                                int32_t duplicate_factor, uint64_t seed,
                                uint64_t bucket, int32_t cls_id,
                                int32_t sep_id, int32_t want_ab) {
  auto* tok = (Tokenizer*)h;
  std::vector<TokShard> tshards;
  tokenize_docs_parallel(*tok, buf, starts, ends, n_docs, tshards);
  std::vector<std::vector<Sent>> docs;
  for (const TokShard& s : tshards)
    append_docs(s.ids.data(), s.sent_lens.data(), s.doc_counts.data(),
                (int64_t)s.doc_counts.size(), docs);

  std::vector<PairsShard> pshards;
  std::vector<InstRef> refs;
  run_pairs(docs, max_seq_length, short_seq_prob, duplicate_factor, seed,
            bucket, cls_id, sep_id, tok->nthreads, tok->busy_ns, pshards,
            refs);

  int64_t n_inst = (int64_t)refs.size();
  CounterRNG kr;
  kr.seed({kPairShuffleTag, seed, bucket});
  std::vector<int64_t> perm = stable_shuffle_perm(kr.key, n_inst);

  int64_t total_ids = 0, total_a = 0;
  for (const InstRef& rf : refs) {
    total_ids += rf.len;
    total_a += rf.a_len;
  }
  auto* res = new InstResult();
  res->n_instances = n_inst;
  res->seq_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n_inst);
  res->a_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n_inst);
  res->is_random_next = (uint8_t*)malloc((size_t)n_inst);
  res->n_seq_ids = total_ids;
  res->seq_ids = (int32_t*)malloc(sizeof(int32_t) * (size_t)total_ids);
  res->a_ids = nullptr;
  res->b_ids = nullptr;
  res->n_a_ids = 0;
  res->n_b_ids = 0;
  if (want_ab) {
    res->n_a_ids = total_a;
    res->n_b_ids = total_ids - total_a - 3 * n_inst;
    res->a_ids = (int32_t*)malloc(sizeof(int32_t) * (size_t)res->n_a_ids);
    res->b_ids = (int32_t*)malloc(sizeof(int32_t) * (size_t)res->n_b_ids);
  }
  int64_t pos = 0, apos = 0, bpos = 0;
  for (int64_t r = 0; r < n_inst; ++r) {
    const InstRef& rf = refs[(size_t)perm[(size_t)r]];
    int32_t len = rf.len;
    memcpy(res->seq_ids + pos, rf.p, sizeof(int32_t) * (size_t)len);
    pos += len;
    int32_t a = rf.a_len;
    res->seq_lens[r] = len;
    res->a_lens[r] = a;
    res->is_random_next[r] = rf.rn;
    if (want_ab) {
      int32_t b = len - a - 3;
      memcpy(res->a_ids + apos, rf.p + 1, sizeof(int32_t) * (size_t)a);
      memcpy(res->b_ids + bpos, rf.p + 2 + a, sizeof(int32_t) * (size_t)b);
      apos += a;
      bpos += b;
    }
  }
  return res;
}

void lddl_inst_free(InstResult* r) {
  free(r->seq_ids);
  free(r->seq_lens);
  free(r->a_lens);
  free(r->is_random_next);
  free(r->a_ids);
  free(r->b_ids);
  delete r;
}

void lddl_inst_release(InstResult* r) { delete r; }

// Static MLM masking over a padded id matrix — bit-exact replay of
// ops.masking.mask_batch_numpy on the numpy-Philox stream whose 16-byte
// key the caller passes (utils.rng.sample_key_bytes). Draw order is
// frozen to the numpy kernel's: scores[n*width doubles], action[n*width
// doubles], random ids[n*width bounded int64 draws]; selection is the
// per-row k-th-smallest-score threshold (identical doubles -> identical
// comparisons). random_token_low is fixed at 0 and vocab_size must be in
// [2, 2^32) — the Python binding falls back to numpy otherwise.
void lddl_mask_batch(uint64_t key0, uint64_t key1, const int32_t* ids,
                     const uint8_t* candidate, const int64_t* num_to_predict,
                     int64_t n, int64_t width, int32_t mask_id,
                     int64_t vocab_size, int32_t* out_ids,
                     uint8_t* out_selected, int32_t nthreads) {
  NumpyPhilox g(key0, key1);
  philox_mask_replay(
      g, n, width, num_to_predict, mask_id, vocab_size,
      [&](int64_t r, int64_t c) { return candidate[r * width + c] != 0; },
      [&](int64_t r, int64_t c) { return ids[r * width + c]; },
      out_selected, out_ids, clamp_threads(nthreads, n), nullptr);
}

struct MaskedInstResult {
  int32_t* a_lens;
  int32_t* seq_lens;
  uint8_t* is_random_next;
  int64_t n_instances;
  int32_t* a_ids;  // MASKED flat A segments row-major
  int64_t n_a_ids;
  int32_t* b_ids;  // MASKED flat B segments row-major
  int64_t n_b_ids;
  int32_t* mlm_pos;     // row-relative selected positions, row-major
  int32_t* mlm_labels;  // ORIGINAL ids at the selected positions
  int32_t* mlm_lens;    // per-instance selected count
  int64_t n_mlm;
};

// FUSED-MASKED hot path: everything lddl_bert_instances does PLUS the
// static-MLM masking replay, in one call — no separate lddl_mask_batch
// pass and no padded [n, width] matrices on the Python side. The replay
// is bit-exact to ops.masking.mask_batch_numpy on the numpy-Philox
// stream (key0, key1): draws are consumed over the VIRTUAL padded matrix
// the staged path would build — width = max(width_min,
// round_up(max_seq_len, width_min)), scores/action/random-id draws for
// all n*width cells in row-major order — so selections and replacement
// ids are identical double-for-double (pinned by tests/test_fused.py).
// num_to_predict replays numpy's plan_num_to_predict: min(max_pred,
// max(1, round-half-even(seq_len * ratio))).
MaskedInstResult* lddl_bert_instances_masked(
    void* h, const char* buf, const int64_t* starts, const int64_t* ends,
    int64_t n_docs, int32_t max_seq_length, double short_seq_prob,
    int32_t duplicate_factor, uint64_t seed, uint64_t bucket,
    int32_t cls_id, int32_t sep_id, uint64_t key0, uint64_t key1,
    int32_t mask_id, int64_t vocab_size, double masked_lm_ratio,
    int32_t max_predictions, int32_t width_min) {
  auto* tok = (Tokenizer*)h;
  std::vector<TokShard> tshards;
  tokenize_docs_parallel(*tok, buf, starts, ends, n_docs, tshards);
  std::vector<std::vector<Sent>> docs;
  for (const TokShard& s : tshards)
    append_docs(s.ids.data(), s.sent_lens.data(), s.doc_counts.data(),
                (int64_t)s.doc_counts.size(), docs);

  std::vector<PairsShard> pshards;
  std::vector<InstRef> refs;
  run_pairs(docs, max_seq_length, short_seq_prob, duplicate_factor, seed,
            bucket, cls_id, sep_id, tok->nthreads, tok->busy_ns, pshards,
            refs);

  int64_t n = (int64_t)refs.size();
  CounterRNG kr;
  kr.seed({kPairShuffleTag, seed, bucket});
  std::vector<int64_t> perm = stable_shuffle_perm(kr.key, n);

  auto* res = new MaskedInstResult();
  res->n_instances = n;
  res->a_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n);
  res->seq_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n);
  res->is_random_next = (uint8_t*)malloc((size_t)n);
  res->mlm_lens = (int32_t*)malloc(sizeof(int32_t) * (size_t)n);
  res->a_ids = nullptr;
  res->b_ids = nullptr;
  res->mlm_pos = nullptr;
  res->mlm_labels = nullptr;
  res->n_a_ids = res->n_b_ids = res->n_mlm = 0;
  if (n == 0) return res;

  // Instance views in SHUFFLED order (the order the padded matrix — and
  // therefore the draw stream — uses).
  std::vector<const int32_t*> rowp((size_t)n);
  int64_t max_len = 0, total_a = 0, total = 0;
  for (int64_t r = 0; r < n; ++r) {
    const InstRef& rf = refs[(size_t)perm[(size_t)r]];
    rowp[(size_t)r] = rf.p;
    res->seq_lens[r] = rf.len;
    res->a_lens[r] = rf.a_len;
    res->is_random_next[r] = rf.rn;
    if (rf.len > max_len) max_len = rf.len;
    total_a += rf.a_len;
    total += rf.len;
  }
  res->n_a_ids = total_a;
  res->n_b_ids = total - total_a - 3 * n;
  res->a_ids = (int32_t*)malloc(sizeof(int32_t) * (size_t)res->n_a_ids);
  res->b_ids = (int32_t*)malloc(sizeof(int32_t) * (size_t)res->n_b_ids);

  // Virtual padded-matrix geometry (ops.packing.round_up semantics).
  int64_t width = ((max_len - 1) / width_min + 1) * (int64_t)width_min;
  if (width < width_min) width = width_min;

  // plan_num_to_predict: numpy round() is round-half-to-even, which is
  // exactly C's nearbyint under the default FE_TONEAREST mode.
  std::vector<int64_t> ntp((size_t)n);
  for (int64_t r = 0; r < n; ++r) {
    double planned = std::nearbyint((double)res->seq_lens[r] *
                                    masked_lm_ratio);
    int64_t v = (int64_t)planned;
    if (v < 1) v = 1;
    if (v > max_predictions) v = max_predictions;
    ntp[(size_t)r] = v;
  }

  NumpyPhilox g(key0, key1);
  std::vector<uint8_t> selected((size_t)(n * width), 0);
  std::vector<int32_t> masked((size_t)(n * width), 0);

  // candidate(r, c) = c < len && c != 0 && c != a+1 && c != len-1
  // (valid, not [CLS]/[SEP]) — computed on the fly over the VIRTUAL
  // padded matrix; pads draw but are never candidates, exactly like the
  // materialized matrix in the staged path. The replay itself is the
  // shared philox_mask_replay core (one copy of the frozen contract),
  // row-partitioned across the handle's worker threads.
  philox_mask_replay(
      g, n, width, ntp.data(), mask_id, vocab_size,
      [&](int64_t r, int64_t c) {
        int64_t len = res->seq_lens[r];
        return c > 0 && c < len - 1 && c != (int64_t)res->a_lens[r] + 1;
      },
      [&](int64_t r, int64_t c) {
        // pads never selected; 0 mirrors nothing (value unused)
        return c < (int64_t)res->seq_lens[r] ? rowp[(size_t)r][c] : 0;
      },
      selected.data(), masked.data(), tok->nthreads, tok->busy_ns);

  // Assembly: masked A/B segments + row-relative selection triples.
  int64_t sum_ntp = 0;
  for (int64_t r = 0; r < n; ++r) sum_ntp += ntp[(size_t)r];
  std::vector<int32_t> pos_v, lab_v;
  pos_v.reserve((size_t)sum_ntp);
  lab_v.reserve((size_t)sum_ntp);
  int64_t apos = 0, bpos = 0;
  for (int64_t r = 0; r < n; ++r) {
    int64_t len = res->seq_lens[r];
    int64_t a = res->a_lens[r];
    const int32_t* m_row = masked.data() + r * width;
    const int32_t* src_row = rowp[(size_t)r];
    memcpy(res->a_ids + apos, m_row + 1, sizeof(int32_t) * (size_t)a);
    apos += a;
    int64_t b = len - a - 3;
    memcpy(res->b_ids + bpos, m_row + 2 + a, sizeof(int32_t) * (size_t)b);
    bpos += b;
    const uint8_t* sel = selected.data() + r * width;
    int32_t cnt = 0;
    for (int64_t c = 1; c < len - 1; ++c) {  // col 0 / len-1 never selected
      if (sel[c]) {
        pos_v.push_back((int32_t)c);
        lab_v.push_back(src_row[c]);
        ++cnt;
      }
    }
    res->mlm_lens[r] = cnt;
  }
  res->n_mlm = (int64_t)pos_v.size();
  res->mlm_pos = (int32_t*)malloc(sizeof(int32_t) * pos_v.size());
  memcpy(res->mlm_pos, pos_v.data(), sizeof(int32_t) * pos_v.size());
  res->mlm_labels = (int32_t*)malloc(sizeof(int32_t) * lab_v.size());
  memcpy(res->mlm_labels, lab_v.data(), sizeof(int32_t) * lab_v.size());
  return res;
}

void lddl_masked_inst_free(MaskedInstResult* r) {
  free(r->a_lens);
  free(r->seq_lens);
  free(r->is_random_next);
  free(r->a_ids);
  free(r->b_ids);
  free(r->mlm_pos);
  free(r->mlm_labels);
  free(r->mlm_lens);
  delete r;
}

// Sentence-split documents given as (start, end) byte ranges of one
// buffer (zero-copy BART path; same splitter semantics as
// lddl_split_docs2).
SplitResult* lddl_split_docs_spans(const char* buf, const int64_t* starts,
                                   const int64_t* ends, int64_t n_docs,
                                   const char* params_blob,
                                   int64_t params_len, int32_t nthreads) {
  PunktParams* pk = (params_blob != nullptr && params_len > 0)
      ? PunktParams::parse(params_blob, params_len) : nullptr;
  auto* res = new SplitResult();
  // Per-document work is independent (pk is read-only): contiguous
  // document slices split in parallel, stitched in thread order.
  struct Shard {
    std::vector<int64_t> starts, ends;
    std::vector<int32_t> doc_counts;
  };
  int nt = clamp_threads(nthreads, n_docs);
  std::vector<Shard> shards((size_t)nt);
  run_parallel(nt, nullptr, [&](int t) {
    int64_t lo = n_docs * t / nt, hi = n_docs * (t + 1) / nt;
    Shard& sh = shards[(size_t)t];
    Utf8Doc doc;
    std::vector<SentRange> sents;
    for (int64_t d = lo; d < hi; ++d) {
      decode_utf8(buf, starts[d], ends[d], doc);
      split_sentences_cp(doc.cps, sents, pk);
      for (const SentRange& s : sents) {
        sh.starts.push_back(doc.byte_off[s.start]);
        sh.ends.push_back(doc.byte_off[s.end]);
      }
      sh.doc_counts.push_back((int32_t)sents.size());
    }
  });
  delete pk;
  size_t n_sents = 0;
  for (const Shard& sh : shards) n_sents += sh.starts.size();
  res->n_sents = (int64_t)n_sents;
  res->starts = (int64_t*)malloc(sizeof(int64_t) * n_sents);
  res->ends = (int64_t*)malloc(sizeof(int64_t) * n_sents);
  res->n_docs = n_docs;
  res->doc_sent_counts = (int32_t*)malloc(sizeof(int32_t) * (size_t)n_docs);
  size_t ps = 0, pd = 0;
  for (const Shard& sh : shards) {
    memcpy(res->starts + ps, sh.starts.data(),
           sizeof(int64_t) * sh.starts.size());
    memcpy(res->ends + ps, sh.ends.data(),
           sizeof(int64_t) * sh.ends.size());
    ps += sh.starts.size();
    memcpy(res->doc_sent_counts + pd, sh.doc_counts.data(),
           sizeof(int32_t) * sh.doc_counts.size());
    pd += sh.doc_counts.size();
  }
  return res;
}

// v3: + lddl_tok_set_memo_cap; v4: + lddl_join_tokens; v5: learned
// splitter; v6: fused lddl_bert_instances + lddl_mask_batch +
// ownership-transfer release entry points + lddl_split_docs_spans;
// v7: fused-masked lddl_bert_instances_masked (in-kernel Philox masking
// replay emitting mask-selection positions directly); v8: in-kernel
// thread pool (lddl_tok_set_threads/lddl_tok_get_threads/
// lddl_tok_thread_busy_ns; nthreads params on lddl_bert_pairs,
// lddl_mask_batch, lddl_split_docs_spans) + sentence-run memo — shard
// bytes are thread-count-invariant by construction.
int lddl_native_abi_version() { return 8; }

}  // extern "C"
