// Native host pipeline of docodo_tpu_torch: a trimmed copy of
// docodo_tpu/native/docodo_native.cpp, the host hot loops that feed the
// device build (the reference engine runs these inside the .NET
// runtime: tokenizer ref Docodo.NET/Build.cs:526-531, word interning
// via SortedList ref Build.cs:302-316):
//
//   * tokenize+intern: one pass over UTF-16 code units — case-fold,
//     letter/digit classification, token segmentation (\p{L}+|\p{N}+,
//     length 3..32 like ref Index.cs:97,113) and term-id interning into
//     an open-addressing hash map with a string arena; the same pass
//     emitting the device build's packed token rows;
//   * the English (Porter2) stemmer a word at a time and in bulk, the
//     Russian (Snowball) one in bulk;
//   * the 15-bit varint codec of the .index file and its record walk.
//
// Exposed as a C ABI for ctypes; fold/class tables are built in Python
// (from Python's str.lower()/unicodedata) and passed in, so the native
// code has no Unicode tables of its own and matches the Python
// tokenizer bit-for-bit. Built by native/__init__.py with g++ at first
// use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Interner {
    // open addressing, power-of-two capacity
    // ONE 8-byte record per slot: (hash high-32 tag << 32) | (id + 1),
    // 0 = empty. The old layout probed two side-by-side arrays (16 B
    // per slot) and the intern pass is probe-latency-bound once the
    // table outgrows L2 (r5 probe: intern 119.6 vs scan-only 269.7
    // MB/s); halving the random-access footprint is the lever. A
    // 32-bit tag false positive is rejected by the memcmp, so
    // correctness is unchanged.
    std::vector<uint64_t> slots;
    // entries: flat arena of u16 strings
    std::vector<uint16_t> arena;
    std::vector<int64_t> offs;       // entry -> arena offset
    std::vector<int32_t> lens;       // entry -> length

    Interner() : slots(1 << 16, 0) {}

    static uint64_t hash(const uint16_t* s, int32_t len) {
        // chunked multiply-xor (4 units = 8 bytes per mix): the
        // per-unit FNV loop was ~5-8 dependent multiplies per token
        // and the intern pass bounds the build producer (r5 probe:
        // 119.6 MB/s intern vs 269.7 scan-only). Hash choice is
        // internal — term ids stay insertion-ordered, outputs
        // bit-identical.
        const uint64_t M = 0x9DDFEA08EB382D69ull;
        uint64_t h = 0x9E3779B97F4A7C15ull ^ ((uint64_t)len << 1);
        int32_t i = 0;
        for (; i + 4 <= len; i += 4) {
            uint64_t k;
            std::memcpy(&k, s + i, 8);
            k *= M;
            k ^= k >> 29;
            h = (h ^ k) * M;
        }
        if (i < len) {
            uint64_t tail = 0;
            std::memcpy(&tail, s + i, (size_t)(len - i) * 2);
            h = (h ^ tail) * M;
        }
        h ^= h >> 32;
        return h | 1;  // nonzero
    }

    void grow() {
        size_t ncap = slots.size() * 2;
        std::vector<uint64_t> ns(ncap, 0);
        for (size_t i = 0; i < slots.size(); i++) {
            uint64_t rec = slots[i];
            if (!rec) continue;
            int64_t e = (int64_t)(uint32_t)rec - 1;
            uint64_t h = hash(&arena[offs[e]], lens[e]);
            size_t j = h & (ncap - 1);
            while (ns[j]) j = (j + 1) & (ncap - 1);
            ns[j] = rec;
        }
        slots.swap(ns);
    }

    int32_t intern(const uint16_t* s, int32_t len) {
        if (offs.size() * 10 >= slots.size() * 7) grow();
        uint64_t h = hash(s, len);
        uint64_t tag = h & 0xFFFFFFFF00000000ull;
        size_t mask = slots.size() - 1;
        size_t j = h & mask;
        uint64_t rec;
        while ((rec = slots[j])) {
            if ((rec & 0xFFFFFFFF00000000ull) == tag) {
                int64_t e = (int64_t)(uint32_t)rec - 1;
                if (lens[e] == len &&
                    std::memcmp(&arena[offs[e]], s, len * 2) == 0)
                    return (int32_t)e;
            }
            j = (j + 1) & mask;
        }
        int32_t id = (int32_t)offs.size();
        offs.push_back((int64_t)arena.size());
        lens.push_back(len);
        arena.insert(arena.end(), s, s + len);
        slots[j] = tag | (uint32_t)(id + 1);
        return id;
    }
};

}  // namespace

extern "C" {

void* docodo_interner_new() { return new Interner(); }

void docodo_interner_free(void* p) { delete (Interner*)p; }

int64_t docodo_interner_count(void* p) {
    return (int64_t)((Interner*)p)->offs.size();
}

// Copy term `i` (UTF-16 units) into out (cap units); returns its
// length (more than cap: call again with a larger buffer), or -1 for an
// id out of range.
int32_t docodo_interner_get(void* p, int64_t i, uint16_t* out, int32_t cap) {
    Interner* in = (Interner*)p;
    if (i < 0 || (size_t)i >= in->offs.size()) return -1;
    int32_t len = in->lens[i];
    int32_t n = len < cap ? len : cap;
    std::memcpy(out, &in->arena[in->offs[i]], n * 2);
    return len;
}

// Range export for incremental consumers: units + lengths of terms
// [lo, hi). The arena is append-only in id order, so the slice is
// contiguous. Returns the unit count copied (or required, out=null).
int64_t docodo_interner_export_range(
    void* p, int64_t lo, int64_t hi, uint16_t* units, int32_t* lens_out) {
    Interner* in = (Interner*)p;
    if (lo < 0) lo = 0;
    if (hi > (int64_t)in->offs.size()) hi = (int64_t)in->offs.size();
    if (lo >= hi) return 0;
    int64_t start = in->offs[lo];
    int64_t end = in->offs[hi - 1] + in->lens[hi - 1];
    if (units) std::memcpy(units, &in->arena[start], (end - start) * 2);
    if (lens_out) std::memcpy(lens_out, &in->lens[lo], (hi - lo) * 4);
    return end - start;
}

// One-pass tokenize + intern.
//   units      : UTF-16 code units of the RAW text, length n
//   fold       : 65536-entry case-fold table (unit -> lowercased unit;
//                units whose Python lower() is not a single same-length
//                unit must be pre-folded by the caller)
//   cls        : 65536-entry class table: 0 other, 1 letter, 2 digit
//   min/max len: token length filter (0 disables — emit all runs)
//   out_ids    : term id per kept token
//   out_starts : unit offset per kept token
// Returns number of kept tokens (bounded by max_tokens).
int64_t docodo_tokenize_intern(
    void* interner, const uint16_t* units, int64_t n,
    const uint16_t* fold, const uint8_t* cls,
    int32_t min_len, int32_t max_len,
    int32_t* out_ids, int32_t* out_starts, int64_t max_tokens) {
    Interner* in = (Interner*)interner;
    int64_t count = 0;
    uint16_t buf[64];
    int64_t i = 0;
    while (i < n && count < max_tokens) {
        uint8_t c = cls[units[i]];
        if (c == 0) {
            i++;
            continue;
        }
        int64_t start = i;
        int32_t len = 0;
        while (i < n && cls[units[i]] == c) {
            if (len < 64) buf[len] = fold[units[i]];
            len++;
            i++;
        }
        if (min_len && (len < min_len || len > max_len)) continue;
        if (len > 64) continue;
        out_ids[count] = in->intern(buf, len);
        out_starts[count] = (int32_t)start;
        count++;
    }
    return count;
}

// One-pass tokenize + intern + pack: the device build's packed token
// stream (ops/device_index.pack_tokens) straight from the scan, one
// uint32 a token (12-bit coordinate delta | 20-bit term id); a gap of
// 4095 units or more first emits escape rows (delta 4095, term
// sentinel 2^20 - 1) that advance the coordinate cursor without a
// posting. Returns the row count, or -1 once the vocabulary reaches the
// sentinel id (the caller raises: the ids no longer fit a row).
int64_t docodo_tokenize_intern_packed(
    void* interner, const uint16_t* units, int64_t n,
    const uint16_t* fold, const uint8_t* cls,
    int32_t min_len, int32_t max_len,
    uint32_t* out, int64_t max_rows) {
    Interner* in = (Interner*)interner;
    const uint32_t SENT = (1u << 20) - 1;
    const int64_t DMAX = (1 << 12) - 1;
    int64_t count = 0;
    uint16_t buf[64];
    int64_t i = 0, prev = 0;
    while (i < n && count < max_rows) {
        uint8_t c = cls[units[i]];
        if (c == 0) {
            i++;
            continue;
        }
        int64_t start = i;
        int32_t len = 0;
        while (i < n && cls[units[i]] == c) {
            if (len < 64) buf[len] = fold[units[i]];
            len++;
            i++;
        }
        if (min_len && (len < min_len || len > max_len)) continue;
        if (len > 64) continue;
        int32_t id = in->intern(buf, len);
        if ((uint32_t)id >= SENT) return -1;
        int64_t d = start - prev;
        while (d >= DMAX && count < max_rows) {
            out[count++] = ((uint32_t)DMAX << 20) | SENT;
            d -= DMAX;
        }
        if (count >= max_rows) break;
        out[count++] = ((uint32_t)d << 20) | (uint32_t)id;
        prev = start;
    }
    return count;
}

// ---------------------------------------------------------------------
// English Porter2 stemmer — a byte-exact twin of the pure-Python
// implementation in lang/stemmers.py:stem_en (itself validated against
// the reference's Iveonik/Snowball stemmer via the shipped Dict/en.voc
// key set). ASCII lowercase input only; returns the stemmed length, or
// -1 for inputs this fast path does not cover (non-ASCII, too long) —
// the caller then falls back to the Python implementation. A fuzz test
// pins native == Python on corpus vocab and random strings.

static int en_is_vowel(char c) {
    return c=='a'||c=='e'||c=='i'||c=='o'||c=='u'||c=='y';
}

// position after the first non-vowel following a vowel, from `start`
// ('Y' marker counts as a consonant, matching _region_after_vc)
static int en_region(const char* w, int n, int start) {
    int i = start;
    while (i < n && !en_is_vowel(w[i])) i++;
    while (i < n && en_is_vowel(w[i])) i++;
    if (i < n) { int r = i + 1; return r < n ? r : n; }
    return n;
}

static int en_r1(const char* w, int n) {
    if (n >= 5 && !memcmp(w, "gener", 5)) return 5;
    if (n >= 6 && !memcmp(w, "commun", 6)) return 6;
    if (n >= 5 && !memcmp(w, "arsen", 5)) return 5;
    return en_region(w, n, 0);
}

static int en_short_syllable_at_end(const char* w, int n) {
    if (n >= 3) {
        char a = w[n-3], b = w[n-2], c = w[n-1];
        if (en_is_vowel(b) && !en_is_vowel(c) && c!='w' && c!='x' && c!='Y'
            && !en_is_vowel(a))
            return 1;
    }
    if (n == 2 && en_is_vowel(w[0]) && !en_is_vowel(w[1])) return 1;
    return 0;
}

static int en_ends(const char* w, int n, const char* suf) {
    int m = (int)strlen(suf);
    return n >= m && !memcmp(w + n - m, suf, m);
}

static int64_t stem_en_one(const char* in, int64_t len, char* out) {
    if (len > 60) return -1;
    for (int64_t i = 0; i < len; i++) {
        unsigned char c = (unsigned char)in[i];
        if (c >= 0x80) return -1;
    }
    char w[64];
    int n = (int)len;
    memcpy(w, in, n);
    w[n] = 0;
    if (n <= 2) { memcpy(out, w, n); return n; }

    static const char* exc_from[11] = {
        "skis","skies","dying","lying","tying","idly","gently","ugly",
        "early","only","singly"};
    static const char* exc_to[11] = {
        "ski","sky","die","lie","tie","idl","gentl","ugli",
        "earli","onli","singl"};
    for (int i = 0; i < 11; i++) {
        if ((int)strlen(exc_from[i]) == n && !memcmp(w, exc_from[i], n)) {
            int m = (int)strlen(exc_to[i]);
            memcpy(out, exc_to[i], m);
            return m;
        }
    }
    static const char* invariants[7] = {
        "sky","news","howe","atlas","cosmos","bias","andes"};
    for (int i = 0; i < 7; i++) {
        if ((int)strlen(invariants[i]) == n && !memcmp(w, invariants[i], n)) {
            memcpy(out, w, n);
            return n;
        }
    }

    if (w[0] == '\'') { memmove(w, w + 1, n - 1); n--; }
    if (w[0] == 'y') w[0] = 'Y';
    for (int i = 1; i < n; i++)
        if (w[i] == 'y' && en_is_vowel(w[i-1])) w[i] = 'Y';

    int r1 = en_r1(w, n);
    int r2 = en_region(w, n, r1);

    // step 0
    if (en_ends(w, n, "'s'")) n -= 3;
    else if (en_ends(w, n, "'s")) n -= 2;
    else if (en_ends(w, n, "'")) n -= 1;

    // step 1a
    if (en_ends(w, n, "sses")) n -= 2;
    else if (en_ends(w, n, "ied") || en_ends(w, n, "ies")) {
        if (n > 4) { n -= 3; w[n++] = 'i'; }
        else       { n -= 3; w[n++] = 'i'; w[n++] = 'e'; }
    } else if (en_ends(w, n, "us") || en_ends(w, n, "ss")) {
        // keep
    } else if (en_ends(w, n, "s")) {
        int has_v = 0;
        for (int i = 0; i < n - 2; i++)
            if (en_is_vowel(w[i])) { has_v = 1; break; }
        if (has_v) n -= 1;
    }

    static const char* exc2[8] = {
        "inning","outing","canning","herring","earring",
        "proceed","exceed","succeed"};
    for (int i = 0; i < 8; i++) {
        if ((int)strlen(exc2[i]) == n && !memcmp(w, exc2[i], n)) {
            for (int j = 0; j < n; j++)
                out[j] = w[j] == 'Y' ? 'y' : w[j];
            return n;
        }
    }

    // step 1b
    {
        static const char* sufs[6] = {
            "eedly","ingly","edly","eed","ing","ed"};
        int si = -1, sl = 0;
        for (int i = 0; i < 6; i++)
            if (en_ends(w, n, sufs[i])) { si = i; sl = (int)strlen(sufs[i]); break; }
        if (si == 0 || si == 3) {                 // eedly / eed
            if (n - sl >= r1) { n -= sl; w[n++] = 'e'; w[n++] = 'e'; }
        } else if (si >= 0) {
            int has_v = 0;
            for (int i = 0; i < n - sl; i++)
                if (en_is_vowel(w[i])) { has_v = 1; break; }
            if (has_v) {
                n -= sl;
                if (en_ends(w, n, "at") || en_ends(w, n, "bl")
                    || en_ends(w, n, "iz")) {
                    w[n++] = 'e';
                } else if (n >= 2 && w[n-1] == w[n-2]
                           && strchr("bdfgmnprt", w[n-1])) {
                    n -= 1;
                } else if (r1 >= n && en_short_syllable_at_end(w, n)) {
                    w[n++] = 'e';
                }
            }
        }
    }

    // step 1c
    if (n > 2 && (w[n-1]=='y' || w[n-1]=='Y') && !en_is_vowel(w[n-2]))
        w[n-1] = 'i';

    // step 2 (suffix in R1)
    {
        static const char* sufs[23] = {
            "ization","ational","fulness","ousness","iveness","tional",
            "biliti","lessli","entli","ation","alism","aliti","ousli",
            "iviti","fulli","enci","anci","abli","izer","ator","alli",
            "bli","ogi"};
        static const char* reps[23] = {
            "ize","ate","ful","ous","ive","tion","ble","less","ent",
            "ate","al","al","ous","ive","ful","ence","ance","able",
            "ize","ate","al","ble",0};
        int done = 0;
        for (int i = 0; i < 23; i++) {
            int sl = (int)strlen(sufs[i]);
            if (en_ends(w, n, sufs[i])) {
                if (n - sl >= r1) {
                    if (i == 22) {                       // ogi
                        if (en_ends(w, n, "logi")) n -= 1;
                    } else {
                        n -= sl;
                        int rl = (int)strlen(reps[i]);
                        memcpy(w + n, reps[i], rl);
                        n += rl;
                    }
                }
                done = 1;
                break;
            }
        }
        if (!done && en_ends(w, n, "li")) {
            if (n - 2 >= r1 && n >= 3 && strchr("cdeghkmnrt", w[n-3]))
                n -= 2;
        }
    }

    // step 3 (suffix in R1; ative needs R2)
    {
        static const char* sufs[9] = {
            "ational","tional","alize","icate","iciti","ative","ical",
            "ness","ful"};
        static const char* reps[9] = {
            "ate","tion","al","ic","ic","","ic","",""};
        for (int i = 0; i < 9; i++) {
            int sl = (int)strlen(sufs[i]);
            if (en_ends(w, n, sufs[i])) {
                if (n - sl >= r1) {
                    if (i == 5) {                        // ative
                        if (n - sl >= r2) n -= sl;
                    } else {
                        n -= sl;
                        int rl = (int)strlen(reps[i]);
                        memcpy(w + n, reps[i], rl);
                        n += rl;
                    }
                }
                break;
            }
        }
    }

    // step 4 (suffix in R2)
    {
        static const char* sufs[18] = {
            "ement","ance","ence","able","ible","ment","ant","ent",
            "ism","ate","iti","ous","ive","ize","ion","al","er","ic"};
        for (int i = 0; i < 18; i++) {
            int sl = (int)strlen(sufs[i]);
            if (en_ends(w, n, sufs[i])) {
                if (n - sl >= r2) {
                    if (i == 14) {                       // ion
                        if (n >= 4 && (w[n-4]=='s' || w[n-4]=='t')) n -= 3;
                    } else {
                        n -= sl;
                    }
                }
                break;
            }
        }
    }

    // step 5
    if (n >= 1 && w[n-1] == 'e') {
        if (n - 1 >= r2
            || (n - 1 >= r1 && !en_short_syllable_at_end(w, n - 1)))
            n -= 1;
    } else if (n >= 2 && w[n-1] == 'l') {
        if (n - 1 >= r2 && w[n-2] == 'l') n -= 1;
    }

    for (int j = 0; j < n; j++)
        out[j] = w[j] == 'Y' ? 'y' : w[j];
    return n;
}

// One word: the stem's length in out (64 bytes suffice), or -1 for a
// word this path does not cover (non-ASCII, longer than 60).
int64_t docodo_stem_en(const char* in, int64_t len, char* out) {
    return stem_en_one(in, len, out);
}

// Bulk stem: words concatenated in `blob` with per-word `lens`;
// stems concatenate into out_blob (capacity >= total_in + 2*n),
// out_lens[i] = stem length or -1 (word not covered — caller falls
// back to Python for that word). Returns total output bytes.
int64_t docodo_stem_en_bulk(
    const char* blob, const int32_t* lens, int64_t n,
    char* out_blob, int32_t* out_lens) {
    int64_t ip = 0, op = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t r = stem_en_one(blob + ip, lens[i], out_blob + op);
        out_lens[i] = (int32_t)r;
        if (r > 0) op += r;
        ip += lens[i];
    }
    return op;
}

// ===========================================================================
// Russian Snowball stemmer on cp1251 bytes (lang/stemmers.py stem_ru's
// byte-parity twin; ref engine ships a NuGet Snowball binary). cp1251
// encodes every lowercase Cyrillic letter in ONE byte, so the whole
// algorithm is byte-oriented like the Porter2 path above. The suffix
// tables are generated from the Python tuples (see lang/stemmers.py
// _RU_*) — same entries, same order (longest-match-first semantics are
// table-order semantics, exactly as the Python loop).
// ===========================================================================

static const char* RU_PG1[] = {"\xe2\xf8\xe8\xf1\xfc", "\xe2\xf8\xe8", "\xe2"};
static const int RU_PG1_N = 3;
static const char* RU_PG2[] = {"\xe8\xe2\xf8\xe8\xf1\xfc", "\xfb\xe2\xf8\xe8\xf1\xfc", "\xe8\xe2\xf8\xe8", "\xfb\xe2\xf8\xe8", "\xe8\xe2", "\xfb\xe2"};
static const int RU_PG2_N = 6;
static const char* RU_ADJ[] = {"\xe8\xec\xe8", "\xfb\xec\xe8", "\xe5\xe3\xee", "\xee\xe3\xee", "\xe5\xec\xf3", "\xee\xec\xf3", "\xe5\xe5", "\xe8\xe5", "\xfb\xe5", "\xee\xe5", "\xe5\xe9", "\xe8\xe9", "\xfb\xe9", "\xee\xe9", "\xe5\xec", "\xe8\xec", "\xfb\xec", "\xee\xec", "\xe8\xf5", "\xfb\xf5", "\xf3\xfe", "\xfe\xfe", "\xe0\xff", "\xff\xff", "\xee\xfe", "\xe5\xfe"};
static const int RU_ADJ_N = 26;
static const char* RU_PART1[] = {"\xe5\xec", "\xed\xed", "\xe2\xf8", "\xfe\xf9", "\xf9"};
static const int RU_PART1_N = 5;
static const char* RU_PART2[] = {"\xe8\xe2\xf8", "\xfb\xe2\xf8", "\xf3\xfe\xf9"};
static const int RU_PART2_N = 3;
static const char* RU_REFL[] = {"\xf1\xff", "\xf1\xfc"};
static const int RU_REFL_N = 2;
static const char* RU_VERB1[] = {"\xe5\xf8\xfc", "\xed\xed\xee", "\xe5\xf2\xe5", "\xe9\xf2\xe5", "\xeb\xe0", "\xed\xe0", "\xeb\xe8", "\xe5\xec", "\xeb\xee", "\xed\xee", "\xe5\xf2", "\xfe\xf2", "\xed\xfb", "\xf2\xfc", "\xe9", "\xeb", "\xed"};
static const int RU_VERB1_N = 17;
static const char* RU_VERB2[] = {"\xe5\xe9\xf2\xe5", "\xf3\xe9\xf2\xe5", "\xe8\xeb\xe0", "\xfb\xeb\xe0", "\xe5\xed\xe0", "\xe8\xf2\xe5", "\xe8\xeb\xe8", "\xfb\xeb\xe8", "\xe8\xeb\xee", "\xfb\xeb\xee", "\xe5\xed\xee", "\xf3\xe5\xf2", "\xf3\xfe\xf2", "\xe5\xed\xfb", "\xe8\xf2\xfc", "\xfb\xf2\xfc", "\xe8\xf8\xfc", "\xe5\xe9", "\xf3\xe9", "\xe8\xeb", "\xfb\xeb", "\xe8\xec", "\xfb\xec", "\xe5\xed", "\xff\xf2", "\xe8\xf2", "\xfb\xf2", "\xf3\xfe", "\xfe"};
static const int RU_VERB2_N = 29;
static const char* RU_NOUN[] = {"\xe8\xff\xec\xe8", "\xff\xec\xe8", "\xe0\xec\xe8", "\xe8\xe5\xe9", "\xe8\xff\xec", "\xe8\xe5\xec", "\xe8\xff\xf5", "\xe5\xe2", "\xee\xe2", "\xe8\xe5", "\xfc\xe5", "\xe5\xe8", "\xe8\xe8", "\xe5\xe9", "\xee\xe9", "\xe8\xe9", "\xff\xec", "\xe5\xec", "\xe0\xec", "\xee\xec", "\xe0\xf5", "\xff\xf5", "\xe8\xfe", "\xfc\xfe", "\xe8\xff", "\xfc\xff", "\xe0", "\xe5", "\xe8", "\xe9", "\xee", "\xf3", "\xfb", "\xfc", "\xfe", "\xff"};
static const int RU_NOUN_N = 36;
static const char* RU_SUP[] = {"\xe5\xe9\xf8\xe5", "\xe5\xe9\xf8"};
static const int RU_SUP_N = 2;

static inline bool ru_vowel(unsigned char c) {
    // cp1251: а е и о у ы э ю я
    return c == 0xe0 || c == 0xe5 || c == 0xe8 || c == 0xee ||
           c == 0xf3 || c == 0xfb || c == 0xfd || c == 0xfe || c == 0xff;
}

// position after the first non-vowel following a vowel, from `start`
// (lang/stemmers.py _region_after_vc)
static int ru_region_after_vc(const unsigned char* w, int n, int start) {
    int i = start;
    while (i < n && !ru_vowel(w[i])) i++;
    while (i < n && ru_vowel(w[i])) i++;
    return i < n ? (i + 1 < n ? i + 1 : n) : n;
}

// longest (= first in table order) suffix inside RV; with preceded_ay
// the byte before it must be а/я and inside RV. Returns suffix length
// or 0.
static int ru_ends(const unsigned char* w, int n, int rv,
                   const char** tab, int tn, bool preceded_ay) {
    for (int t = 0; t < tn; t++) {
        int sl = (int)std::strlen(tab[t]);
        if (n - sl >= rv && sl <= n &&
            std::memcmp(w + n - sl, tab[t], sl) == 0) {
            if (preceded_ay) {
                int i = n - sl - 1;
                if (i >= rv && (w[i] == 0xe0 || w[i] == 0xff)) return sl;
            } else {
                return sl;
            }
        }
    }
    return 0;
}

// stem one cp1251 word in place; returns new length
static int docodo_stem_ru_one(unsigned char* w, int n) {
    for (int i = 0; i < n; i++)
        if (w[i] == 0xb8) w[i] = 0xe5;  // ё -> е
    int rv = n;
    for (int i = 0; i < n; i++) {
        if (ru_vowel(w[i])) { rv = i + 1; break; }
    }
    int r1 = ru_region_after_vc(w, n, 0);
    int r2 = ru_region_after_vc(w, n, r1);
    if (rv >= n) return n;

    // step 1: perfective gerund, else [reflexive] + adjectival|verb|noun
    int sl = ru_ends(w, n, rv, RU_PG2, RU_PG2_N, false);
    if (!sl) sl = ru_ends(w, n, rv, RU_PG1, RU_PG1_N, true);
    if (sl) {
        n -= sl;
    } else {
        int rl = ru_ends(w, n, rv, RU_REFL, RU_REFL_N, false);
        if (rl) n -= rl;
        int al = ru_ends(w, n, rv, RU_ADJ, RU_ADJ_N, false);
        if (al) {
            n -= al;
            int pl = ru_ends(w, n, rv, RU_PART2, RU_PART2_N, false);
            if (!pl) pl = ru_ends(w, n, rv, RU_PART1, RU_PART1_N, true);
            if (pl) n -= pl;
        } else {
            int vl = ru_ends(w, n, rv, RU_VERB2, RU_VERB2_N, false);
            if (!vl) vl = ru_ends(w, n, rv, RU_VERB1, RU_VERB1_N, true);
            if (vl) {
                n -= vl;
            } else {
                int nl = ru_ends(w, n, rv, RU_NOUN, RU_NOUN_N, false);
                if (nl) n -= nl;
            }
        }
    }

    // step 2: trailing и
    if (n >= 1 && w[n - 1] == 0xe8 && n - 1 >= rv) n -= 1;

    // step 3: derivational ость/ост in R2
    {
        static const char* OST4 = "\xee\xf1\xf2\xfc";
        static const char* OST3 = "\xee\xf1\xf2";
        if (n >= 4 && n - 4 >= r2 && std::memcmp(w + n - 4, OST4, 4) == 0)
            n -= 4;
        else if (n >= 3 && n - 3 >= r2 && std::memcmp(w + n - 3, OST3, 3) == 0)
            n -= 3;
    }

    // step 4: нн | superlative [нн] | ь
    if (n >= 2 && w[n - 1] == 0xed && w[n - 2] == 0xed && n - 1 >= rv) {
        n -= 1;
    } else {
        int ssl = ru_ends(w, n, rv, RU_SUP, RU_SUP_N, false);
        if (ssl) {
            n -= ssl;
            if (n >= 2 && w[n - 1] == 0xed && w[n - 2] == 0xed &&
                n - 1 >= rv)
                n -= 1;
        } else if (n >= 1 && w[n - 1] == 0xfc && n - 1 >= rv) {
            n -= 1;
        }
    }
    return n;
}

// Bulk ru stem: cp1251 words concatenated in `blob` with per-word
// `lens`; stems concatenate into out_blob (capacity >= total_in),
// out_lens[i] = stem length. Returns total output bytes.
int64_t docodo_stem_ru_bulk(
    const char* blob, const int32_t* lens, int64_t n,
    char* out_blob, int32_t* out_lens) {
    int64_t ip = 0, op = 0;
    for (int64_t i = 0; i < n; i++) {
        int ln = lens[i];
        std::memcpy(out_blob + op, blob + ip, ln);
        int r = docodo_stem_ru_one(
            reinterpret_cast<unsigned char*>(out_blob + op), ln);
        out_lens[i] = (int32_t)r;
        op += r;
        ip += ln;
    }
    return op;
}

// 15-bit varint encode (core/varint.py): deltas of ascending u64
// coordinates into u16 words, 15 payload bits each, low chunk first,
// MSB = more chunks of this delta follow. Returns the word count; pass
// out=null to size.
int64_t docodo_varint_encode(
    const uint64_t* coords, int64_t n, uint16_t* out) {
    int64_t w = 0;
    uint64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t d = coords[i] - prev;
        prev = coords[i];
        do {
            uint16_t chunk = (uint16_t)(d & 0x7FFF);
            d >>= 15;
            if (d) chunk |= 0x8000;
            if (out) out[w] = chunk;
            w++;
        } while (d);
    }
    return w;
}

// Encode many posting blocks in one pass: offsets[b]:offsets[b+1]
// delimit block b in coords; each block's deltas restart (its first
// delta is its first coordinate), as per-block docodo_varint_encode.
// word_starts[b] receives block b's first word index (nblocks + 1
// slots). Returns the total word count.
int64_t docodo_varint_encode_blocks(
    const uint64_t* coords, const int64_t* offsets, int64_t nblocks,
    uint16_t* out, int64_t* word_starts) {
    int64_t w = 0;
    for (int64_t b = 0; b < nblocks; b++) {
        word_starts[b] = w;
        uint64_t prev = 0;
        for (int64_t i = offsets[b]; i < offsets[b + 1]; i++) {
            uint64_t d = coords[i] - prev;
            prev = coords[i];
            do {
                uint16_t chunk = (uint16_t)(d & 0x7FFF);
                d >>= 15;
                if (d) chunk |= 0x8000;
                out[w] = chunk;
                w++;
            } while (d);
        }
    }
    word_starts[nblocks] = w;
    return w;
}

// Decode a u16 varint stream back into ascending u64 coordinates.
// Returns the coordinate count; pass out=null to size.
int64_t docodo_varint_decode(
    const uint16_t* words, int64_t nwords, uint64_t* out) {
    int64_t c = 0;
    uint64_t acc = 0;
    uint64_t cur = 0;
    int shift = 0;
    for (int64_t i = 0; i < nwords; i++) {
        uint16_t w = words[i];
        cur |= (uint64_t)(w & 0x7FFF) << shift;
        if (w & 0x8000) {
            shift += 15;
        } else {
            acc += cur;
            if (out) out[c] = acc;
            c++;
            cur = 0;
            shift = 0;
        }
    }
    return c;
}

// Decode the posting spans of an .index stream at once: span s is
// span_words[s] u16 words (little-endian, at any byte alignment) at
// byte span_off[s] of buf, delta-coded from 0. Its coordinates go to
// out after those of the spans before it, and counts[s] receives how
// many. Returns the total count; out needs a slot a word at most.
int64_t docodo_varint_decode_spans(
    const uint8_t* buf, const int64_t* span_off, const int32_t* span_words,
    int64_t nspans, uint64_t* out, int64_t* counts) {
    int64_t c = 0;
    for (int64_t s = 0; s < nspans; s++) {
        const uint8_t* p = buf + span_off[s];
        const int64_t c0 = c;
        uint64_t acc = 0;
        uint64_t cur = 0;
        int shift = 0;
        for (int32_t i = 0; i < span_words[s]; i++) {
            uint16_t w = (uint16_t)(p[2 * i] | (p[2 * i + 1] << 8));
            if (shift < 64) cur |= (uint64_t)(w & 0x7FFF) << shift;
            if (w & 0x8000) {
                shift += 15;
            } else {
                acc += cur;
                out[c++] = acc;
                cur = 0;
                shift = 0;
            }
        }
        counts[s] = c - c0;
    }
    return c;
}

// Walk the record framing of an .index stream (core/storage.py) after
// its 8-byte max_coord header: each record's term byte offset and
// length, and its posting span's byte offset and word count. Returns
// the record count, or -1 on a truncated or corrupt stream. Callers
// size the outputs at (n - 8) / 5 + 1 records (the least record: a
// 1-byte length, an empty term and a 4-byte count).
// The whole records of an index stream from byte `start` on, at most
// max_records of them: each record's term (byte offset, length) and its
// u16 words (byte offset, count). Stops before a record the n bytes do
// not hold whole and sets *end to the byte after the last record parsed.
// Returns the records, or -1 for a stream no writer makes (a runaway
// length, a negative count).
int64_t docodo_parse_records_from(const uint8_t* buf, int64_t n,
                                  int64_t start, int64_t max_records,
                                  int64_t* term_off, int32_t* term_len,
                                  int64_t* span_off, int32_t* span_words,
                                  int64_t* end) {
    int64_t pos = start, cnt = 0;
    *end = start;
    while (pos < n && cnt < max_records) {
        int64_t slen = 0;
        int shift = 0;
        for (;;) {
            if (pos >= n) return cnt;
            if (shift > 63) return -1;  // a runaway 7-bit length
            uint8_t b = buf[pos++];
            slen |= (int64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        if (slen < 0) return -1;
        if (pos + slen + 4 > n) return cnt;
        const int64_t toff = pos;
        pos += slen;
        int32_t nw;
        std::memcpy(&nw, buf + pos, 4);
        pos += 4;
        if (nw < 0) return -1;
        if (pos + 2 * (int64_t)nw > n) return cnt;
        term_off[cnt] = toff;
        term_len[cnt] = (int32_t)slen;
        span_off[cnt] = pos;
        span_words[cnt] = nw;
        pos += 2 * nw;
        *end = pos;
        cnt++;
    }
    return cnt;
}

}  // extern "C"
