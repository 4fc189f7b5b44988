// msk_frame: shared codec unit for the native serving edge (ISSUE 16).
//
// Everything the C++ frontend tier needs to speak the repo's existing
// binary contracts without CPython in the loop:
//
//  * MSK1 client wire (utils/wire.py twin — same header layout, same
//    rejection SENTENCES: the typed-400 bodies are part of the client
//    contract and the parity tests diff them byte-for-byte),
//  * the decimal int32 text codec (textcodec.cpp's fmt/parse logic,
//    inlined here so frontend.so has no cross-.so dependency) for the
//    /compute and /compute_batch text lanes,
//  * SHA-256 + HMAC-SHA256 (API-key digesting: runtime/edge.py._digest
//    is HMAC(b"misaka-api-key-v1", key) — the control plane pushes hex
//    digests, never raw keys, and the edge digests inbound keys to
//    match),
//  * a minimal recursive-descent JSON reader/writer for the plane frame
//    metadata and the control-plane push payloads.
//
// Header-only; include from frontend.cpp only.  No exceptions, no RTTI
// requirements, C++17.

#pragma once

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace msk {

// ---------------------------------------------------------------------------
// MSK1 binary wire (utils/wire.py)
// ---------------------------------------------------------------------------

constexpr uint32_t kWireMagic = 0x314B534D;  // b"MSK1" little-endian
constexpr uint16_t kWireVersion = 1;
constexpr size_t kWireHeaderLen = 12;
constexpr const char* kWireContentType = "application/x-misaka-i32";

inline void wire_header(uint32_t count, uint8_t out[kWireHeaderLen]) {
    uint32_t magic = kWireMagic;
    uint16_t ver = kWireVersion, flags = 0;
    std::memcpy(out, &magic, 4);
    std::memcpy(out + 4, &ver, 2);
    std::memcpy(out + 6, &flags, 2);
    std::memcpy(out + 8, &count, 4);
}

// Validate an MSK1 body; on success set *payload/*payload_len to the raw
// int32 bytes and return true.  On failure fill err with the exact
// wire.WireError sentence the CPython tier would raise.
inline bool wire_unpack(const uint8_t* body, size_t len,
                        const uint8_t** payload, size_t* payload_len,
                        std::string& err) {
    char buf[160];
    if (len < kWireHeaderLen) {
        std::snprintf(buf, sizeof(buf),
                      "body of %zu bytes is shorter than the 12-byte header",
                      len);
        err = buf;
        return false;
    }
    uint32_t magic, count;
    uint16_t version;
    std::memcpy(&magic, body, 4);
    std::memcpy(&version, body + 4, 2);
    std::memcpy(&count, body + 8, 4);
    if (magic != kWireMagic) {
        std::snprintf(buf, sizeof(buf),
                      "bad magic 0x%08x (expected 0x%08x)", magic, kWireMagic);
        err = buf;
        return false;
    }
    if (version != kWireVersion) {
        std::snprintf(buf, sizeof(buf), "unsupported protocol version %u",
                      (unsigned)version);
        err = buf;
        return false;
    }
    const size_t n = len - kWireHeaderLen;
    if (n != (uint64_t)count * 4) {
        std::snprintf(buf, sizeof(buf),
                      "header promises %u values but body carries "
                      "%zu payload bytes", count, n);
        err = buf;
        return false;
    }
    *payload = body + kWireHeaderLen;
    *payload_len = n;
    return true;
}

// Content-Type selects the headered binary request form?  Mirrors
// wire.is_binary: split on ';', strip, exact compare.
inline bool wire_is_binary(const std::string& ctype) {
    size_t end = ctype.find(';');
    if (end == std::string::npos) end = ctype.size();
    size_t a = 0;
    while (a < end && (ctype[a] == ' ' || ctype[a] == '\t')) a++;
    while (end > a && (ctype[end - 1] == ' ' || ctype[end - 1] == '\t')) end--;
    return ctype.compare(a, end - a, kWireContentType) == 0;
}

// Accept negotiates the binary response?  Mirrors wire.accepts_binary:
// plain substring containment.
inline bool wire_accepts_binary(const std::string& accept) {
    return accept.find(kWireContentType) != std::string::npos;
}

// ---------------------------------------------------------------------------
// Decimal int32 text codec (textcodec.cpp logic, same output bytes)
// ---------------------------------------------------------------------------

namespace detail {

const char kPairs[] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

inline void write_digits(char* end, uint32_t m, int nd) {
    char* p = end;
    while (nd >= 2) {
        const uint32_t q = m / 100u, r = m - q * 100u;
        p -= 2;
        std::memcpy(p, kPairs + 2 * r, 2);
        m = q;
        nd -= 2;
    }
    if (nd) *--p = (char)('0' + m % 10u);
}

inline bool is_sep(uint8_t c) {
    return c == ' ' || c == ',' || c == '+' || c == '\t' || c == '\n' ||
           c == '\r';
}

inline int ndigits_u32(uint32_t m) {
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
    return x < 0 ? (uint32_t)(-(int64_t)x) : (uint32_t)x;
}

}  // namespace detail

// Format n int32 values joined by `sep` (textcodec fmt, zero_pad=False):
// fixed-width fields of 1 + digits(max |v|), right-aligned, padded with
// the separator itself when it is ' ' or '+' (else ' '), '-' immediately
// left of the top digit, one separator between tokens, no trailer.
inline void fmt_i32(const int32_t* v, size_t n, char sep, std::string& out) {
    if (n == 0) return;
    uint32_t maxmag = 0;
    for (size_t i = 0; i < n; i++) {
        uint32_t m = detail::mag_u32(v[i]);
        if (m > maxmag) maxmag = m;
    }
    const int width = detail::ndigits_u32(maxmag) + 1;
    const char pad = (sep == ' ' || sep == '+') ? sep : ' ';
    const size_t base = out.size();
    out.resize(base + n * (size_t)(width + 1) - 1);
    char* p = &out[base];
    for (size_t i = 0; i < n; i++) {
        const int32_t x = v[i];
        const uint32_t m = detail::mag_u32(x);
        const int nd = detail::ndigits_u32(m);
        for (int j = 0; j < width - nd; j++) p[j] = pad;
        detail::write_digits(p + width, m, nd);
        if (x < 0) p[width - 1 - nd] = '-';
        p += width;
        if (i + 1 < n) *p++ = sep;
    }
}

// Parse separator-joined decimal tokens (textcodec parse).  Returns
// false on malformed / out-of-int32-range input — the caller answers the
// typed 400 the CPython lane would.
inline bool parse_i32(const char* s, size_t len, std::vector<int32_t>& out) {
    size_t i = 0;
    const uint64_t LIM = 1ull << 31;
    while (i < len) {
        uint8_t c = (uint8_t)s[i];
        if (detail::is_sep(c)) {
            i++;
            continue;
        }
        bool neg = false;
        if (c == '-') {
            neg = true;
            i++;
            if (i >= len || s[i] < '0' || s[i] > '9') return false;
        } else if (c < '0' || c > '9') {
            return false;
        }
        uint64_t mag = 0;
        bool big = false;
        while (i < len) {
            c = (uint8_t)s[i];
            if (c >= '0' && c <= '9') {
                if (!big) {
                    mag = mag * 10u + (uint64_t)(c - '0');
                    if (mag > LIM) big = true;
                }
                i++;
            } else if (detail::is_sep(c)) {
                break;
            } else {
                return false;
            }
        }
        if (big || (neg ? mag > LIM : mag > LIM - 1)) return false;
        out.push_back(neg ? (int32_t)(-(int64_t)mag) : (int32_t)mag);
    }
    return true;
}

// ---------------------------------------------------------------------------
// SHA-256 + HMAC-SHA256 (API-key digesting; no OpenSSL dependency)
// ---------------------------------------------------------------------------

struct Sha256 {
    uint32_t h[8];
    uint8_t block[64];
    uint64_t total = 0;
    size_t fill = 0;

    Sha256() {
        static const uint32_t init[8] = {
            0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
            0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
        };
        std::memcpy(h, init, sizeof(h));
    }

    static uint32_t rotr(uint32_t x, int n) {
        return (x >> n) | (x << (32 - n));
    }

    void compress(const uint8_t* p) {
        static const uint32_t K[64] = {
            0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
            0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
            0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
            0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
            0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
            0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
            0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
            0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
            0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
            0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
            0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
            0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
            0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
        };
        uint32_t w[64];
        for (int i = 0; i < 16; i++) {
            w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16)
                 | ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
        }
        for (int i = 16; i < 64; i++) {
            const uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18)
                              ^ (w[i - 15] >> 3);
            const uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19)
                              ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            const uint32_t ch = (e & f) ^ (~e & g);
            const uint32_t t1 = hh + S1 + ch + K[i] + w[i];
            const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            const uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const uint8_t* p, size_t n) {
        total += n;
        while (n) {
            const size_t take = (64 - fill < n) ? 64 - fill : n;
            std::memcpy(block + fill, p, take);
            fill += take;
            p += take;
            n -= take;
            if (fill == 64) {
                compress(block);
                fill = 0;
            }
        }
    }

    void finish(uint8_t out[32]) {
        const uint64_t bits = total * 8;
        const uint8_t one = 0x80;
        update(&one, 1);
        const uint8_t zero = 0;
        while (fill != 56) update(&zero, 1);
        uint8_t lenb[8];
        for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
        update(lenb, 8);
        for (int i = 0; i < 8; i++) {
            out[4 * i] = (uint8_t)(h[i] >> 24);
            out[4 * i + 1] = (uint8_t)(h[i] >> 16);
            out[4 * i + 2] = (uint8_t)(h[i] >> 8);
            out[4 * i + 3] = (uint8_t)h[i];
        }
    }
};

inline void hmac_sha256(const uint8_t* key, size_t key_len,
                        const uint8_t* msg, size_t msg_len,
                        uint8_t out[32]) {
    uint8_t k[64];
    std::memset(k, 0, sizeof(k));
    if (key_len > 64) {
        Sha256 kh;
        kh.update(key, key_len);
        kh.finish(k);
    } else {
        std::memcpy(k, key, key_len);
    }
    uint8_t ipad[64], opad[64];
    for (int i = 0; i < 64; i++) {
        ipad[i] = k[i] ^ 0x36;
        opad[i] = k[i] ^ 0x5c;
    }
    uint8_t inner[32];
    Sha256 hi;
    hi.update(ipad, 64);
    hi.update(msg, msg_len);
    hi.finish(inner);
    Sha256 ho;
    ho.update(opad, 64);
    ho.update(inner, 32);
    ho.finish(out);
}

// runtime/edge.py._digest(key): HMAC-SHA256(b"misaka-api-key-v1", key),
// rendered as lowercase hex (the push payload carries hex digests).
inline std::string api_key_digest_hex(const std::string& key) {
    static const char tag[] = "misaka-api-key-v1";
    uint8_t mac[32];
    hmac_sha256((const uint8_t*)tag, sizeof(tag) - 1,
                (const uint8_t*)key.data(), key.size(), mac);
    static const char hexd[] = "0123456789abcdef";
    std::string out(64, '0');
    for (int i = 0; i < 32; i++) {
        out[2 * i] = hexd[mac[i] >> 4];
        out[2 * i + 1] = hexd[mac[i] & 0xf];
    }
    return out;
}

// ---------------------------------------------------------------------------
// Minimal JSON (plane metadata + control-plane push payloads)
// ---------------------------------------------------------------------------

struct JsonValue {
    enum Kind { Null, Bool, Number, String, Array, Object } kind = Null;
    bool boolean = false;
    double number = 0.0;
    std::string str;
    std::vector<JsonValue> arr;
    std::vector<std::pair<std::string, JsonValue>> obj;

    const JsonValue* get(const char* key) const {
        for (const auto& kv : obj) {
            if (kv.first == key) return &kv.second;
        }
        return nullptr;
    }
    std::string get_str(const char* key, const char* dflt = "") const {
        const JsonValue* v = get(key);
        return (v && v->kind == String) ? v->str : std::string(dflt);
    }
    double get_num(const char* key, double dflt = 0.0) const {
        const JsonValue* v = get(key);
        return (v && v->kind == Number) ? v->number : dflt;
    }
    bool get_bool(const char* key, bool dflt = false) const {
        const JsonValue* v = get(key);
        if (v == nullptr) return dflt;
        if (v->kind == Bool) return v->boolean;
        if (v->kind == Number) return v->number != 0.0;
        return dflt;
    }
};

namespace detail {

struct JsonParser {
    const char* p;
    const char* end;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r')) {
            p++;
        }
    }

    bool lit(const char* s, size_t n) {
        if ((size_t)(end - p) < n || std::memcmp(p, s, n) != 0) return false;
        p += n;
        return true;
    }

    static void utf8_append(std::string& s, uint32_t cp) {
        if (cp < 0x80) {
            s.push_back((char)cp);
        } else if (cp < 0x800) {
            s.push_back((char)(0xc0 | (cp >> 6)));
            s.push_back((char)(0x80 | (cp & 0x3f)));
        } else if (cp < 0x10000) {
            s.push_back((char)(0xe0 | (cp >> 12)));
            s.push_back((char)(0x80 | ((cp >> 6) & 0x3f)));
            s.push_back((char)(0x80 | (cp & 0x3f)));
        } else {
            s.push_back((char)(0xf0 | (cp >> 18)));
            s.push_back((char)(0x80 | ((cp >> 12) & 0x3f)));
            s.push_back((char)(0x80 | ((cp >> 6) & 0x3f)));
            s.push_back((char)(0x80 | (cp & 0x3f)));
        }
    }

    bool hex4(uint32_t& out) {
        if (end - p < 4) return false;
        out = 0;
        for (int i = 0; i < 4; i++) {
            const char c = *p++;
            out <<= 4;
            if (c >= '0' && c <= '9') out |= (uint32_t)(c - '0');
            else if (c >= 'a' && c <= 'f') out |= (uint32_t)(c - 'a' + 10);
            else if (c >= 'A' && c <= 'F') out |= (uint32_t)(c - 'A' + 10);
            else return false;
        }
        return true;
    }

    bool parse_string(std::string& out) {
        if (p >= end || *p != '"') return false;
        p++;
        while (p < end) {
            const unsigned char c = (unsigned char)*p;
            if (c == '"') {
                p++;
                return true;
            }
            if (c == '\\') {
                p++;
                if (p >= end) return false;
                const char e = *p++;
                switch (e) {
                    case '"': out.push_back('"'); break;
                    case '\\': out.push_back('\\'); break;
                    case '/': out.push_back('/'); break;
                    case 'b': out.push_back('\b'); break;
                    case 'f': out.push_back('\f'); break;
                    case 'n': out.push_back('\n'); break;
                    case 'r': out.push_back('\r'); break;
                    case 't': out.push_back('\t'); break;
                    case 'u': {
                        uint32_t cp;
                        if (!hex4(cp)) return false;
                        if (cp >= 0xd800 && cp <= 0xdbff && end - p >= 6 &&
                            p[0] == '\\' && p[1] == 'u') {
                            p += 2;
                            uint32_t lo;
                            if (!hex4(lo)) return false;
                            if (lo >= 0xdc00 && lo <= 0xdfff) {
                                cp = 0x10000 + ((cp - 0xd800) << 10)
                                   + (lo - 0xdc00);
                            } else {
                                utf8_append(out, cp);
                                cp = lo;
                            }
                        }
                        utf8_append(out, cp);
                        break;
                    }
                    default: return false;
                }
            } else if (c < 0x20) {
                return false;
            } else {
                out.push_back((char)c);
                p++;
            }
        }
        return false;
    }

    bool parse_value(JsonValue& out, int depth) {
        if (depth > 48) return false;
        skip_ws();
        if (p >= end) return false;
        const char c = *p;
        if (c == '{') {
            p++;
            out.kind = JsonValue::Object;
            skip_ws();
            if (p < end && *p == '}') {
                p++;
                return true;
            }
            while (true) {
                skip_ws();
                std::string key;
                if (!parse_string(key)) return false;
                skip_ws();
                if (p >= end || *p++ != ':') return false;
                JsonValue v;
                if (!parse_value(v, depth + 1)) return false;
                out.obj.emplace_back(std::move(key), std::move(v));
                skip_ws();
                if (p >= end) return false;
                if (*p == ',') {
                    p++;
                    continue;
                }
                if (*p == '}') {
                    p++;
                    return true;
                }
                return false;
            }
        }
        if (c == '[') {
            p++;
            out.kind = JsonValue::Array;
            skip_ws();
            if (p < end && *p == ']') {
                p++;
                return true;
            }
            while (true) {
                JsonValue v;
                if (!parse_value(v, depth + 1)) return false;
                out.arr.push_back(std::move(v));
                skip_ws();
                if (p >= end) return false;
                if (*p == ',') {
                    p++;
                    continue;
                }
                if (*p == ']') {
                    p++;
                    return true;
                }
                return false;
            }
        }
        if (c == '"') {
            out.kind = JsonValue::String;
            return parse_string(out.str);
        }
        if (c == 't') {
            out.kind = JsonValue::Bool;
            out.boolean = true;
            return lit("true", 4);
        }
        if (c == 'f') {
            out.kind = JsonValue::Bool;
            out.boolean = false;
            return lit("false", 5);
        }
        if (c == 'n') {
            out.kind = JsonValue::Null;
            return lit("null", 4);
        }
        // number: delegate to strtod over a bounded copy
        const char* start = p;
        while (p < end && (std::strchr("+-.eE", *p) != nullptr ||
                           (*p >= '0' && *p <= '9'))) {
            p++;
        }
        if (p == start || (size_t)(p - start) > 64) return false;
        char buf[72];
        std::memcpy(buf, start, (size_t)(p - start));
        buf[p - start] = '\0';
        char* done = nullptr;
        out.kind = JsonValue::Number;
        out.number = std::strtod(buf, &done);
        return done == buf + (p - start);
    }
};

}  // namespace detail

inline bool json_parse(const char* s, size_t len, JsonValue& out) {
    detail::JsonParser jp{s, s + len};
    if (!jp.parse_value(out, 0)) return false;
    jp.skip_ws();
    return jp.p == jp.end;
}

// Append a JSON string literal (with quotes) escaping like json.dumps.
inline void json_append_str(std::string& out, const std::string& s) {
    out.push_back('"');
    for (const char ch : s) {
        const unsigned char c = (unsigned char)ch;
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\b': out += "\\b"; break;
            case '\f': out += "\\f"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    std::snprintf(buf, sizeof(buf), "\\u%04x", c);
                    out += buf;
                } else {
                    out.push_back(ch);
                }
        }
    }
    out.push_back('"');
}

// ---------------------------------------------------------------------------
// Plane frame header (runtime/frontends.py _REQ_HDR / _RESP_HDR)
// ---------------------------------------------------------------------------

constexpr size_t kPlaneReqHeaderLen = 8;   // <II  n_values, n_meta_bytes
constexpr size_t kPlaneRespHeaderLen = 8;  // <iI  status, length
constexpr int kPlaneDraining = 599;        // replica drain sentinel status

inline void plane_req_header(uint32_t n_values, uint32_t n_meta,
                             uint8_t out[kPlaneReqHeaderLen]) {
    std::memcpy(out, &n_values, 4);
    std::memcpy(out + 4, &n_meta, 4);
}

inline void plane_resp_header(const uint8_t* p, int32_t* status,
                              uint32_t* length) {
    std::memcpy(status, p, 4);
    std::memcpy(length, p + 4, 4);
}

}  // namespace msk
