// A Zstandard frame decoder written from RFC 8878 (no library linked), for
// the zarr chunks and OCDBT nodes of orbax checkpoints (io/ocdbt.py,
// io/orbax_format.py). Built by g++ at first use into vitslam_tpu_torch/_build/
// and bound with ctypes by native/bindings.py.
//
//   * frames back to back, skippable frames skipped;
//   * raw, RLE and compressed blocks;
//   * literals raw, RLE, Huffman-coded (one or four streams, the tree given
//     or repeated from the previous block), Huffman weights direct or FSE;
//   * sequences with predefined, RLE, FSE-compressed and repeated tables and
//     the three repeat offsets;
//   * the content checksum (XXH64) checked when the frame carries it.
//
// The whole output lies in one caller-given buffer, so a match may reach
// back anywhere in its frame and no window is allocated. Dictionaries are
// refused. Every table read, literal copy and match copy is bounds-checked:
// corrupt input is an error, never a read or write out of bounds.
//
// Also here: CRC-32C (Castagnoli), the checksum of OCDBT's manifests and
// B-tree nodes.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
    char buf[256];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw Error(buf);
}

inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t)p[1] << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t)p[2] << 16; }
inline uint32_t le32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t le64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---- XXH64 -----------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, le64(p));
            v2 = xround(v2, le64(p + 8));
            v3 = xround(v3, le64(p + 16));
            v4 = xround(v4, le64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = P5;
    }
    h += n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t)le32(p) * P1, 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// ---- bit readers -------------------------------------------------------------

// Backward bit stream (Huffman and FSE streams): read from the end toward the
// start; the last byte's highest set bit marks where the stream begins. Bits
// below the start read as zeros (pos goes negative), which the callers check.
struct BackBits {
    const uint8_t* p = nullptr;
    size_t n = 0;
    int64_t pos = 0;  // bits not yet read

    void init(const uint8_t* src, size_t size, const char* what) {
        if (size == 0) fail("%s: empty bit stream", what);
        uint8_t last = src[size - 1];
        if (last == 0) fail("%s: bit stream lacks its end mark", what);
        p = src;
        n = size;
        pos = (int64_t)(size - 1) * 8 + highbit(last);
    }
    // the nb (<= 56) bits whose lowest is at bit lo
    inline uint64_t bits_at(int64_t lo, int nb) const {
        if (nb == 0) return 0;
        if (lo >= 0) {
            size_t byte = (size_t)(lo >> 3);
            uint64_t w = 0;
            if (byte + 8 <= n) memcpy(&w, p + byte, 8);
            else memcpy(&w, p + byte, n - byte);
            return (w >> (lo & 7)) & ((1ULL << nb) - 1);
        }
        int64_t have = lo + nb;
        if (have <= 0) return 0;
        uint64_t w = 0;
        memcpy(&w, p, n < 8 ? n : 8);
        return (w & ((1ULL << have) - 1)) << (-lo);
    }
    inline uint64_t peek(int nb) const { return bits_at(pos - nb, nb); }
    inline uint64_t read(int nb) {
        pos -= nb;
        return bits_at(pos, nb);
    }
};

// ---- FSE ---------------------------------------------------------------------

struct FseEntry {
    uint16_t base;  // next state = base + read(nb)
    uint8_t sym;
    uint8_t nb;
};

struct Fse {
    int al = -1;  // accuracy log; -1: no table yet
    std::vector<FseEntry> t;
};

// The normalised counts of an FSE table description (RFC 8878 4.1.1);
// returns the bytes it takes.
size_t read_ncount(const uint8_t* src, size_t size, int max_sym, int max_al,
                   std::vector<int16_t>& norm, int& al, const char* what) {
    size_t bit = 0;
    auto peek = [&](int nb) -> uint32_t {  // LSB first, zeros past the end
        uint32_t v = 0;
        for (int i = 0; i < nb; ++i) {
            size_t b = bit + i;
            if (b / 8 < size) v |= (uint32_t)((src[b / 8] >> (b % 8)) & 1) << i;
        }
        return v;
    };
    al = (int)peek(4) + 5;
    bit += 4;
    if (al > max_al) fail("%s: FSE accuracy log %d above %d", what, al, max_al);
    int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1, sym = 0;
    bool prev0 = false;
    norm.assign(max_sym + 1, 0);
    while (remaining > 1 && sym <= max_sym) {
        if (prev0) {
            int n0 = sym;
            while (peek(2) == 3) {
                n0 += 3;
                bit += 2;
                if (n0 > max_sym + 1) fail("%s: FSE zero run past the last symbol", what);
            }
            n0 += peek(2);
            bit += 2;
            if (n0 > max_sym + 1) fail("%s: FSE zero run past the last symbol", what);
            while (sym < n0) norm[sym++] = 0;
            if (sym > max_sym) break;
        }
        int max = (2 * threshold - 1) - remaining;
        uint32_t v = peek(nbits);
        int count;
        if ((int)(v & (threshold - 1)) < max) {
            count = v & (threshold - 1);
            bit += nbits - 1;
        } else {
            count = v & (2 * threshold - 1);
            if (count >= threshold) count -= max;
            bit += nbits;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = (int16_t)count;
        prev0 = count == 0;
        if (remaining < 1) fail("%s: FSE counts past the table size", what);
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) fail("%s: FSE counts do not sum to the table size", what);
    size_t used = (bit + 7) / 8;
    if (used > size) fail("%s: FSE table description truncated", what);
    norm.resize(sym);
    return used;
}

void build_fse(Fse& f, const std::vector<int16_t>& norm, int al, const char* what) {
    const int size = 1 << al;
    f.al = al;
    f.t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint16_t> next(norm.size());
    int high = size - 1;
    for (size_t s = 0; s < norm.size(); ++s) {
        if (norm[s] == -1) {
            if (high < 0) fail("%s: FSE table overfull", what);
            f.t[high--].sym = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)norm[s];
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (size_t s = 0; s < norm.size(); ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            f.t[pos].sym = (uint8_t)s;
            do pos = (pos + step) & mask; while (pos > high);
        }
    }
    if (pos != 0) fail("%s: FSE table spread does not close", what);
    for (int u = 0; u < size; ++u) {
        int s = f.t[u].sym;
        int x = next[s]++;
        if (x <= 0) fail("%s: FSE state of a symbol without probability", what);
        int nb = al - highbit((uint32_t)x);
        f.t[u].nb = (uint8_t)nb;
        f.t[u].base = (uint16_t)((x << nb) - size);
    }
}

void rle_fse(Fse& f, uint8_t sym) {
    f.al = 0;
    f.t.assign(1, FseEntry{0, sym, 0});
}

// ---- Huffman -------------------------------------------------------------------

struct Huf {
    int max_bits = 0;  // 0: no table yet
    std::vector<uint8_t> sym, nb;
};

// The Huffman tree description of a compressed literals section (RFC 8878
// 4.2.1); returns the bytes it takes.
size_t read_huf(Huf& h, const uint8_t* src, size_t size) {
    if (size < 1) fail("literals: Huffman tree description truncated");
    uint8_t header = src[0];
    std::vector<uint8_t> w;
    size_t used;
    if (header >= 128) {
        int n = header - 127;
        used = 1 + (size_t)(n + 1) / 2;
        if (used > size) fail("literals: Huffman weights truncated");
        for (int i = 0; i < n; ++i) w.push_back(i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15);
    } else {
        used = 1 + (size_t)header;
        if (used > size) fail("literals: Huffman weights truncated");
        std::vector<int16_t> norm;
        int al;
        size_t hdr = read_ncount(src + 1, header, 255, 6, norm, al, "Huffman weights");
        Fse f;
        build_fse(f, norm, al, "Huffman weights");
        BackBits br;
        br.init(src + 1 + hdr, header - hdr, "Huffman weights");
        uint32_t s1 = (uint32_t)br.read(al), s2 = (uint32_t)br.read(al);
        // two interleaved states; once the stream is spent the other state's
        // symbol is the last
        for (;;) {
            if (w.size() >= 255) fail("Huffman weights: more than 255 symbols");
            w.push_back(f.t[s1].sym);
            s1 = f.t[s1].base + (uint32_t)br.read(f.t[s1].nb);
            if (br.pos < 0) { w.push_back(f.t[s2].sym); break; }
            if (w.size() >= 255) fail("Huffman weights: more than 255 symbols");
            w.push_back(f.t[s2].sym);
            s2 = f.t[s2].base + (uint32_t)br.read(f.t[s2].nb);
            if (br.pos < 0) { w.push_back(f.t[s1].sym); break; }
        }
    }
    if (w.size() > 255) fail("Huffman weights: more than 255 symbols");
    uint32_t total = 0;
    for (uint8_t x : w) {
        if (x > 11) fail("Huffman weights: weight %d above 11", x);
        if (x) total += 1u << (x - 1);
    }
    if (total == 0) fail("Huffman weights: all zero");
    int max_bits = highbit(total) + 1;
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) fail("Huffman weights: the implied last weight is not a power of two");
    w.push_back((uint8_t)(highbit(rest) + 1));
    if (max_bits > 11) fail("Huffman weights: code length %d above 11", max_bits);
    h.max_bits = max_bits;
    h.sym.assign(1u << max_bits, 0);
    h.nb.assign(1u << max_bits, 0);
    uint32_t pos = 0;
    for (int weight = 1; weight <= max_bits; ++weight) {
        for (size_t s = 0; s < w.size(); ++s) {
            if (w[s] != weight) continue;
            uint32_t len = 1u << (weight - 1);
            if (pos + len > h.sym.size()) fail("Huffman weights: table overfull");
            memset(&h.sym[pos], (int)s, len);
            memset(&h.nb[pos], max_bits + 1 - weight, len);
            pos += len;
        }
    }
    if (pos != h.sym.size()) fail("Huffman weights: table not full");
    return used;
}

void huf_stream(const Huf& h, const uint8_t* src, size_t size, uint8_t* out, size_t count) {
    BackBits br;
    br.init(src, size, "Huffman literals");
    const int mb = h.max_bits;
    const uint8_t* sym = h.sym.data();
    const uint8_t* nb = h.nb.data();
    size_t i = 0;
    // while 56 or more bits are left, take 8 bytes at once (bit pos - 1 at
    // the top) and decode four symbols (at most 44 bits) from them
    while (i + 4 <= count && br.pos >= 56) {
        const size_t b = (size_t)(br.pos >> 3) - 7;
        uint64_t w;
        memcpy(&w, br.p + b, 8);
        w <<= 64 - (br.pos - 8 * (int64_t)b);
        int used = 0;
        for (int k = 0; k < 4; ++k) {
            const uint64_t v = w >> (64 - mb);
            out[i + k] = sym[v];
            w <<= nb[v];
            used += nb[v];
        }
        br.pos -= used;
        i += 4;
    }
    for (; i < count; ++i) {
        uint64_t v = br.peek(mb);
        out[i] = sym[v];
        br.pos -= nb[v];
    }
    if (br.pos != 0) fail("Huffman literals: stream not consumed exactly (%lld bits left)",
                          (long long)br.pos);
}

// ---- sequences -------------------------------------------------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
    // the output: [start, cap) of the caller's buffer, written up to pos
    uint8_t* out;
    size_t start, pos, cap;
    uint32_t rep[3] = {1, 4, 8};
    Huf huf;
    Fse ll, of, ml;
    std::vector<uint8_t> lit;
};

// One sequence table of a block's sequences section; returns the bytes its
// description takes.
size_t read_table(Fse& f, int mode, const uint8_t* src, size_t size, const int16_t* def,
                  int ndef, int def_al, int max_sym, int max_al, const char* what) {
    switch (mode) {
        case 0: {
            std::vector<int16_t> norm(def, def + ndef);
            build_fse(f, norm, def_al, what);
            return 0;
        }
        case 1:
            if (size < 1) fail("%s: RLE symbol missing", what);
            if (src[0] > max_sym) fail("%s: RLE symbol %d above %d", what, src[0], max_sym);
            rle_fse(f, src[0]);
            return 1;
        case 2: {
            std::vector<int16_t> norm;
            int al;
            size_t used = read_ncount(src, size, max_sym, max_al, norm, al, what);
            build_fse(f, norm, al, what);
            return used;
        }
        default:
            if (f.al < 0) fail("%s: repeat mode with no previous table", what);
            return 0;
    }
}

inline void copy_match(uint8_t* dst, size_t offset, size_t len) {
    const uint8_t* src = dst - offset;
    if (offset >= len) {
        memcpy(dst, src, len);
    } else if (offset >= 8) {
        size_t i = 0;
        for (; i + 8 <= len; i += 8) memcpy(dst + i, src + i, 8);
        for (; i < len; ++i) dst[i] = src[i];
    } else {
        for (size_t i = 0; i < len; ++i) dst[i] = src[i];
    }
}

void compressed_block(Frame& fr, const uint8_t* src, size_t size, size_t block_max) {
    // literals section
    if (size < 1) fail("block: empty compressed block");
    const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    size_t rs, cs = 0, hdr;
    if (type < 2) {
        if (sf == 0 || sf == 2) { rs = src[0] >> 3; hdr = 1; }
        else if (sf == 1) { if (size < 2) fail("literals: header truncated"); rs = le16(src) >> 4; hdr = 2; }
        else { if (size < 3) fail("literals: header truncated"); rs = le24(src) >> 4; hdr = 3; }
    } else {
        if (sf < 2) {
            if (size < 3) fail("literals: header truncated");
            uint32_t c = le24(src);
            rs = (c >> 4) & 0x3FF; cs = (c >> 14) & 0x3FF; hdr = 3;
        } else if (sf == 2) {
            if (size < 4) fail("literals: header truncated");
            uint32_t c = le32(src);
            rs = (c >> 4) & 0x3FFF; cs = (c >> 18) & 0x3FFF; hdr = 4;
        } else {
            if (size < 5) fail("literals: header truncated");
            uint64_t c = le32(src) | (uint64_t)src[4] << 32;
            rs = (c >> 4) & 0x3FFFF; cs = (c >> 22) & 0x3FFFF; hdr = 5;
        }
    }
    if (rs > block_max) fail("literals: %zu literals above the block maximum %zu", rs, block_max);
    fr.lit.resize(rs);
    uint8_t* lit = fr.lit.data();
    size_t p = hdr;
    if (type == 0) {
        if (p + rs > size) fail("literals: raw literals truncated");
        memcpy(lit, src + p, rs);
        p += rs;
    } else if (type == 1) {
        if (p + 1 > size) fail("literals: RLE byte missing");
        memset(lit, src[p], rs);
        p += 1;
    } else {
        if (p + cs > size) fail("literals: compressed literals truncated");
        const uint8_t* q = src + p;
        size_t qn = cs;
        if (type == 2) {
            size_t t = read_huf(fr.huf, q, qn);
            q += t;
            qn -= t;
        } else if (fr.huf.max_bits == 0) {
            fail("literals: treeless literals with no previous Huffman table");
        }
        if (sf == 0) {
            huf_stream(fr.huf, q, qn, lit, rs);
        } else {
            if (qn < 6) fail("literals: jump table truncated");
            size_t s1 = le16(q), s2 = le16(q + 2), s3 = le16(q + 4);
            if (6 + s1 + s2 + s3 > qn) fail("literals: jump table past the streams");
            size_t s4 = qn - 6 - s1 - s2 - s3;
            size_t seg = (rs + 3) / 4;
            if (3 * seg > rs) fail("literals: %zu literals cannot fill four streams", rs);
            const uint8_t* b = q + 6;
            huf_stream(fr.huf, b, s1, lit, seg);
            huf_stream(fr.huf, b + s1, s2, lit + seg, seg);
            huf_stream(fr.huf, b + s1 + s2, s3, lit + 2 * seg, seg);
            huf_stream(fr.huf, b + s1 + s2 + s3, s4, lit + 3 * seg, rs - 3 * seg);
        }
        p += cs;
    }

    // sequences section
    if (p >= size) fail("sequences: section missing");
    size_t nseq = src[p++];
    if (nseq >= 128) {
        if (nseq < 255) {
            if (p >= size) fail("sequences: count truncated");
            nseq = ((nseq - 128) << 8) + src[p++];
        } else {
            if (p + 2 > size) fail("sequences: count truncated");
            nseq = le16(src + p) + 0x7F00;
            p += 2;
        }
    }
    size_t lit_pos = 0;
    uint8_t* out = fr.out;
    if (nseq > 0) {
        if (p >= size) fail("sequences: modes missing");
        uint8_t modes = src[p++];
        if (modes & 3) fail("sequences: reserved bits of the modes byte set");
        p += read_table(fr.ll, modes >> 6, src + p, size - p, LL_DEFAULT, 36, 6, 35, 9,
                        "literal lengths");
        p += read_table(fr.of, (modes >> 4) & 3, src + p, size - p, OF_DEFAULT, 29, 5, 31, 8,
                        "offsets");
        p += read_table(fr.ml, (modes >> 2) & 3, src + p, size - p, ML_DEFAULT, 53, 6, 52, 9,
                        "match lengths");
        if (p >= size) fail("sequences: bit stream missing");
        BackBits br;
        br.init(src + p, size - p, "sequences");
        uint32_t sl = (uint32_t)br.read(fr.ll.al), so = (uint32_t)br.read(fr.of.al),
                 sm = (uint32_t)br.read(fr.ml.al);
        const FseEntry* llt = fr.ll.t.data();
        const FseEntry* oft = fr.of.t.data();
        const FseEntry* mlt = fr.ml.t.data();
        for (size_t i = 0; i < nseq; ++i) {
            const int oc = oft[so].sym, lc = llt[sl].sym, mc = mlt[sm].sym;
            if (lc > 35 || mc > 52 || oc > 31) fail("sequences: code out of range");
            uint64_t ofv = (1ULL << oc) + br.read(oc);
            size_t ml = ML_BASE[mc] + br.read(ML_BITS[mc]);
            size_t ll = LL_BASE[lc] + br.read(LL_BITS[lc]);
            size_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                fr.rep[2] = fr.rep[1];
                fr.rep[1] = fr.rep[0];
                fr.rep[0] = (uint32_t)offset;
            } else {
                int idx = (int)ofv + (ll == 0 ? 1 : 0);
                if (idx == 1) {
                    offset = fr.rep[0];
                } else if (idx == 2) {
                    offset = fr.rep[1];
                    fr.rep[1] = fr.rep[0];
                    fr.rep[0] = (uint32_t)offset;
                } else {
                    offset = idx == 3 ? fr.rep[2] : (size_t)fr.rep[0] - 1;
                    fr.rep[2] = fr.rep[1];
                    fr.rep[1] = fr.rep[0];
                    fr.rep[0] = (uint32_t)offset;
                }
            }
            if (i + 1 < nseq) {
                sl = llt[sl].base + (uint32_t)br.read(llt[sl].nb);
                sm = mlt[sm].base + (uint32_t)br.read(mlt[sm].nb);
                so = oft[so].base + (uint32_t)br.read(oft[so].nb);
            }
            if (br.pos < 0) fail("sequences: bit stream overrun");
            if (ll > fr.lit.size() - lit_pos) fail("sequences: literal length past the literals");
            if (ll + ml > fr.cap - fr.pos) fail("sequences: output past the content size");
            memcpy(out + fr.pos, lit + lit_pos, ll);
            lit_pos += ll;
            fr.pos += ll;
            if (offset == 0 || offset > fr.pos - fr.start)
                fail("sequences: offset %zu reaches before the frame", offset);
            copy_match(out + fr.pos, offset, ml);
            fr.pos += ml;
        }
        if (br.pos != 0) fail("sequences: bit stream not consumed exactly");
    } else if (p != size) {
        fail("sequences: bytes after an empty sequences section");
    }
    size_t rest = fr.lit.size() - lit_pos;
    if (rest > fr.cap - fr.pos) fail("block: output past the content size");
    memcpy(out + fr.pos, lit + lit_pos, rest);
    fr.pos += rest;
}

// One frame at src[0..size); returns the bytes it takes; appends its content
// to out[*pos..cap).
size_t frame(const uint8_t* src, size_t size, uint8_t* out, size_t& pos, size_t cap) {
    if (size < 4) fail("frame: truncated magic number");
    uint32_t magic = le32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (size < 8) fail("skippable frame: truncated size");
        uint64_t n = le32(src + 4);
        if (n > size - 8) fail("skippable frame: truncated");
        return 8 + (size_t)n;
    }
    if (magic != 0xFD2FB528u) fail("frame: bad magic number 0x%08x", magic);
    if (size < 5) fail("frame: truncated header");
    const uint8_t d = src[4];
    const int fcs_flag = d >> 6, single = (d >> 5) & 1, checksum = (d >> 2) & 1, did_flag = d & 3;
    if (d & 8) fail("frame: reserved bit set");
    size_t p = 5;
    uint64_t window = 0;
    if (!single) {
        if (p >= size) fail("frame: truncated header");
        uint8_t wd = src[p++];
        int wlog = 10 + (wd >> 3);
        if (wlog > 41) fail("frame: window log %d", wlog);
        uint64_t base = 1ULL << wlog;
        window = base + (base / 8) * (wd & 7);
    }
    const int did_size[4] = {0, 1, 2, 4};
    if (p + did_size[did_flag] > size) fail("frame: truncated header");
    uint32_t did = 0;
    for (int i = 0; i < did_size[did_flag]; ++i) did |= (uint32_t)src[p + i] << (8 * i);
    p += did_size[did_flag];
    if (did != 0) fail("frame: needs dictionary %u; dictionaries are not supported", did);
    const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
    if (p + fcs_size > size) fail("frame: truncated header");
    bool has_fcs = fcs_size > 0;
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_size; ++i) fcs |= (uint64_t)src[p + i] << (8 * i);
    if (fcs_size == 2) fcs += 256;
    p += fcs_size;
    if (single) window = fcs;
    const size_t block_max = window < (1u << 17) ? (size_t)window : (size_t)1 << 17;

    Frame fr;
    fr.out = out;
    fr.start = fr.pos = pos;
    fr.cap = cap;
    if (has_fcs && fcs > cap - pos)
        fail("frame: content size %llu past the output (%zu bytes left)",
             (unsigned long long)fcs, cap - pos);
    for (bool last = false; !last;) {
        if (p + 3 > size) fail("block: truncated header");
        uint32_t bh = le24(src + p);
        p += 3;
        last = bh & 1;
        const int type = (bh >> 1) & 3;
        const size_t bsize = bh >> 3;
        if (type == 3) fail("block: reserved block type");
        if (type == 1) {
            if (p + 1 > size) fail("block: RLE byte missing");
            if (bsize > block_max) fail("block: %zu bytes above the block maximum", bsize);
            if (bsize > cap - fr.pos) fail("block: output past the content size");
            memset(out + fr.pos, src[p], bsize);
            fr.pos += bsize;
            p += 1;
            continue;
        }
        if (p + bsize > size) fail("block: truncated (%zu of %zu bytes)", size - p, bsize);
        if (bsize > block_max) fail("block: %zu bytes above the block maximum", bsize);
        if (type == 0) {
            if (bsize > cap - fr.pos) fail("block: output past the content size");
            memcpy(out + fr.pos, src + p, bsize);
            fr.pos += bsize;
        } else {
            size_t before = fr.pos;
            compressed_block(fr, src + p, bsize, block_max);
            if (fr.pos - before > block_max) fail("block: decodes past the block maximum");
        }
        p += bsize;
    }
    if (has_fcs && fr.pos - fr.start != fcs)
        fail("frame: decoded %zu bytes, the header says %llu", fr.pos - fr.start,
             (unsigned long long)fcs);
    if (checksum) {
        if (p + 4 > size) fail("frame: checksum truncated");
        uint32_t want = le32(src + p);
        uint32_t got = (uint32_t)xxh64(out + fr.start, fr.pos - fr.start);
        if (got != want) fail("frame: content checksum mismatch (0x%08x, header 0x%08x)", got, want);
        p += 4;
    }
    pos = fr.pos;
    return p;
}

uint32_t CRC32C_TABLE[8][256];

void crc32c_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        CRC32C_TABLE[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
        for (int t = 1; t < 8; ++t)
            CRC32C_TABLE[t][i] = (CRC32C_TABLE[t - 1][i] >> 8) ^ CRC32C_TABLE[0][CRC32C_TABLE[t - 1][i] & 255];
}

}  // namespace

extern "C" {

// Decode the zstd frames of src[0..n) into dst[0..cap): the number of bytes
// decoded, which must be cap when exact is nonzero; -1 with a message in err
// on any error.
int64_t zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap, int exact,
                        char* err, uint64_t errcap) {
    try {
        size_t p = 0, pos = 0;
        if (n == 0) fail("no frame");
        while (p < n) p += frame(src + p, n - p, dst, pos, cap);
        if (exact && pos != cap)
            fail("decoded %zu bytes into a buffer of %llu", pos, (unsigned long long)cap);
        return (int64_t)pos;
    } catch (const std::exception& e) {
        snprintf(err, errcap, "%s", e.what());
        return -1;
    }
}

// The content size the frame headers of src[0..n) declare, summed over the
// frames; -1 when a frame does not declare it, -2 when the frames cannot be
// walked (then zstd_decompress names the fault).
int64_t zstd_content_size(const uint8_t* src, uint64_t n) {
    uint64_t total = 0;
    size_t p = 0;
    while (p < n) {
        if (n - p < 8) return -2;
        uint32_t magic = le32(src + p);
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
            uint64_t skip = le32(src + p + 4);
            if (skip > n - p - 8) return -2;
            p += 8 + skip;
            continue;
        }
        if (magic != 0xFD2FB528u) return -2;
        const uint8_t d = src[p + 4];
        const int fcs_flag = d >> 6, single = (d >> 5) & 1, checksum = (d >> 2) & 1;
        const int did_size[4] = {0, 1, 2, 4};
        const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
        if (fcs_size == 0) return -1;
        size_t q = p + 5 + (single ? 0 : 1) + did_size[d & 3];
        if (q + fcs_size > n) return -2;
        uint64_t fcs = 0;
        for (int i = 0; i < fcs_size; ++i) fcs |= (uint64_t)src[q + i] << (8 * i);
        if (fcs_size == 2) fcs += 256;
        total += fcs;
        q += fcs_size;
        for (bool last = false; !last;) {
            if (q + 3 > n) return -2;
            uint32_t bh = le24(src + q);
            last = bh & 1;
            q += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
        }
        p = q + (checksum ? 4 : 0);
        if (p > n) return -2;
    }
    return (int64_t)total;
}

uint32_t crc32c(const uint8_t* p, uint64_t n) {
    static bool ready = (crc32c_init(), true);
    (void)ready;
    uint32_t c = 0xFFFFFFFFu;
    for (; n >= 8; n -= 8, p += 8) {
        uint64_t v = le64(p) ^ c;
        c = CRC32C_TABLE[7][v & 255] ^ CRC32C_TABLE[6][(v >> 8) & 255] ^
            CRC32C_TABLE[5][(v >> 16) & 255] ^ CRC32C_TABLE[4][(v >> 24) & 255] ^
            CRC32C_TABLE[3][(v >> 32) & 255] ^ CRC32C_TABLE[2][(v >> 40) & 255] ^
            CRC32C_TABLE[1][(v >> 48) & 255] ^ CRC32C_TABLE[0][v >> 56];
    }
    for (; n; --n, ++p) c = (c >> 8) ^ CRC32C_TABLE[0][(c ^ *p) & 255];
    return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
