// Native decimal text codec for int32 value streams — the C++ twin of
// misaka_tpu/utils/textcodec.py (same output bytes, same accept/reject
// language), loaded via ctypes (utils/nativelib.py contract).
//
// Why it exists: the /compute_batch text lane (the reference-shaped client
// surface, /root/reference/internal/nodes/master.go:197-224 moved values as
// decimal form text) serializes millions of integers per request.  The
// numpy codec runs ~2-3.5M ints/s per direction in O(digits) full-array
// passes; this single-pass scalar codec runs the same transform at memory
// speed and, being a plain ctypes call, releases the GIL for its entire
// run — the HTTP threads serving other requests keep moving.
//
// Contract notes (parity with textcodec.py, pinned by
// tests/test_textcodec.py's differential lane):
//  * fmt: fixed-width fields — width = 1 + digits(max |v| in the call),
//    one separator byte between tokens, no trailing separator.  zero_pad
//    pads every digit column with '0' and prints the sign column as '0' or
//    '-'; otherwise tokens are right-aligned, padded with the separator
//    itself when it is ' ' or '+' (else ' '), '-' immediately left of the
//    top digit.
//  * parse: tokens are maximal [0-9-] runs split by any of " ,+\t\n\r";
//    '-' is legal only at a token start and directly before a digit; any
//    other byte, or a value outside int32, rejects the whole stream.

#include <cstdint>
#include <cstring>

namespace {

// two-digit pairs "00".."99": halves the divide chain per token
const char kPairs[] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

// write exactly nd decimal digits of m ending at end[-1] (zero-padded on
// the left when m has fewer than nd digits)
inline void write_digits(uint8_t* end, uint32_t m, int nd) {
  uint8_t* p = end;
  while (nd >= 2) {
    const uint32_t q = m / 100u, r = m - q * 100u;
    p -= 2;
    std::memcpy(p, kPairs + 2 * r, 2);
    m = q;
    nd -= 2;
  }
  if (nd) *--p = (uint8_t)('0' + m % 10u);
}

inline bool is_sep(uint8_t c) {
    return c == ' ' || c == ',' || c == '+' || c == '\t' || c == '\n' ||
           c == '\r';
}

inline int ndigits_u32(uint32_t m) {
    // mirrors textcodec._THRESHOLDS: searchsorted over 10^1..10^9
    if (m < 10u) return 1;
    if (m < 100u) return 2;
    if (m < 1000u) return 3;
    if (m < 10000u) return 4;
    if (m < 100000u) return 5;
    if (m < 1000000u) return 6;
    if (m < 10000000u) return 7;
    if (m < 100000000u) return 8;
    if (m < 1000000000u) return 9;
    return 10;
}

inline uint32_t mag_u32(int32_t x) {
    // |INT32_MIN| fits unsigned, same as the numpy path's uint32 cast
    return x < 0 ? (uint32_t)(-(int64_t)x) : (uint32_t)x;
}

}  // namespace

extern "C" {

// Format n int32 values into out (capacity out_cap bytes).  Returns bytes
// written, or -1 when out_cap cannot hold the result (callers size out at
// 12*n: width <= 11, so a field with its separator is <= 12 bytes).
int64_t misaka_fmt_i32(const int32_t* v, int64_t n, uint8_t sep,
                       int32_t zero_pad, uint8_t* out, int64_t out_cap) {
    if (n <= 0) return 0;
    uint32_t maxmag = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t m = mag_u32(v[i]);
        if (m > maxmag) maxmag = m;
    }
    const int nd_max = ndigits_u32(maxmag);
    const int width = nd_max + 1;  // one extra column for a full-width '-'
    if (n * (int64_t)(width + 1) - 1 > out_cap) return -1;
    const uint8_t pad = (sep == ' ' || sep == '+') ? sep : (uint8_t)' ';
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        const int32_t x = v[i];
        uint32_t m = mag_u32(x);
        uint8_t* f = p;
        if (zero_pad) {
            write_digits(f + width, m, width - 1);
            f[0] = x < 0 ? (uint8_t)'-' : (uint8_t)'0';
        } else {
            const int nd = ndigits_u32(m);
            for (int j = 0; j < width - nd; j++) f[j] = pad;
            write_digits(f + width, m, nd);
            if (x < 0) f[width - 1 - nd] = '-';
        }
        p += width;
        if (i + 1 < n) *p++ = sep;
    }
    return (int64_t)(p - out);
}

// Parse separator-joined decimal tokens into out (capacity out_cap
// values).  Returns the token count, -1 on malformed/out-of-range input,
// -2 when out_cap is too small (unreachable at the caller's (len+1)/2
// sizing: every token but the last needs at least one separator).
int64_t misaka_parse_i32(const uint8_t* s, int64_t len, int32_t* out,
                         int64_t out_cap) {
    int64_t n = 0;
    int64_t i = 0;
    const uint64_t LIM = 1ull << 31;  // > LIM is out of range for any sign
    while (i < len) {
        uint8_t c = s[i];
        if (is_sep(c)) {
            i++;
            continue;
        }
        bool neg = false;
        if (c == '-') {
            neg = true;
            i++;
            if (i >= len || s[i] < '0' || s[i] > '9') return -1;
        } else if (c < '0' || c > '9') {
            return -1;
        }
        uint64_t mag = 0;
        bool big = false;
        while (i < len) {
            c = s[i];
            if (c >= '0' && c <= '9') {
                if (!big) {
                    mag = mag * 10u + (uint64_t)(c - '0');
                    if (mag > LIM) big = true;  // saturate; digits still consumed
                }
                i++;
            } else if (is_sep(c)) {
                break;
            } else {
                return -1;  // '-' mid-token, or a foreign byte
            }
        }
        if (big || (neg ? mag > LIM : mag > LIM - 1)) return -1;
        if (n >= out_cap) return -2;
        out[n++] = neg ? (int32_t)(-(int64_t)mag) : (int32_t)mag;
    }
    return n;
}

}  // extern "C"

// Identity tag for utils/nativelib.py's content-hash staleness check; the
// build injects -DMISAKA_SRC_HASH=<sha256[:16] of this file>.
#ifndef MISAKA_SRC_HASH
#define MISAKA_SRC_HASH "unbuilt"
#endif
extern "C" const char misaka_textcodec_src_hash[] =
    "MISAKA-SRC-HASH:" MISAKA_SRC_HASH;
