// msk_http: HTTP/1.1 codec unit for the native serving edge (ISSUE 16).
//
// Parser + serializer only — no sockets, no event loop (frontend.cpp owns
// those).  The parse limits and keep-alive semantics mirror
// utils/httpfast.py (the CPython tier's fused reader), so the native and
// CPython tiers reject the same malformed inputs with the same statuses:
// request line > 65536 bytes -> 414, a header line > 65536 bytes or more
// than 100 headers -> 431, versions other than HTTP/1.0 / HTTP/1.1 -> 400,
// Expect: 100-continue acknowledged before the body is read.  Keep-alive
// is the HTTP/1.1 default; `Connection: close` (and HTTP/1.0 without
// `keep-alive`) closes after the response.
//
// Header-only; include from frontend.cpp only.  C++17, no exceptions.

#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <map>
#include <string>
#include <utility>
#include <vector>

namespace msk {

constexpr size_t kMaxHttpLine = 65536;
constexpr size_t kMaxHttpHeaders = 100;

struct HttpRequest {
    std::string method;
    std::string target;        // full request-target (path + query)
    std::string path;          // target before '?'
    bool http11 = false;
    bool keep_alive = true;
    bool expect_continue = false;
    bool has_content_length = false;
    bool bad_content_length = false;
    int64_t content_length = 0;
    size_t header_bytes = 0;   // consumed byte count incl. final CRLFCRLF
    // headers with lowercased names, original values (trimmed)
    std::vector<std::pair<std::string, std::string>> headers;

    const std::string* get(const char* lname) const {
        for (const auto& kv : headers) {
            if (kv.first == lname) return &kv.second;
        }
        return nullptr;
    }
    std::string get_str(const char* lname) const {
        const std::string* v = get(lname);
        return v ? *v : std::string();
    }
};

// Incremental request-head parse over buf[0..len).  Returns:
//   1  parsed: req populated, req.header_bytes consumed
//   0  need more bytes
//  -1  protocol error: *err_status is 400/414/431 (connection must close)
inline int http_parse_request(const char* buf, size_t len, HttpRequest& req,
                              int* err_status) {
    // locate the end of the head without scanning unbounded garbage
    const char* head_end = nullptr;
    for (size_t i = 0; i + 3 < len; i++) {
        if (buf[i] == '\r' && buf[i + 1] == '\n' && buf[i + 2] == '\r' &&
            buf[i + 3] == '\n') {
            head_end = buf + i;
            break;
        }
    }
    if (head_end == nullptr) {
        // not complete yet: enforce the line caps on what we can see
        const char* nl = (const char*)std::memchr(buf, '\n', len);
        if (nl == nullptr) {
            if (len > kMaxHttpLine) {
                *err_status = 414;
                return -1;
            }
            return 0;
        }
        if ((size_t)(nl - buf) > kMaxHttpLine) {
            *err_status = 414;
            return -1;
        }
        // a later header line may already exceed the cap
        const char* p = nl + 1;
        size_t seen_headers = 0;
        while (p < buf + len) {
            const char* q =
                (const char*)std::memchr(p, '\n', (size_t)(buf + len - p));
            if (q == nullptr) {
                if ((size_t)(buf + len - p) > kMaxHttpLine) {
                    *err_status = 431;
                    return -1;
                }
                break;
            }
            if ((size_t)(q - p) > kMaxHttpLine) {
                *err_status = 431;
                return -1;
            }
            if (++seen_headers > kMaxHttpHeaders) {
                *err_status = 431;
                return -1;
            }
            p = q + 1;
        }
        return 0;
    }

    req.header_bytes = (size_t)(head_end - buf) + 4;

    // --- request line ---
    const char* line_end = (const char*)std::memchr(buf, '\r',
                                                    req.header_bytes);
    if (line_end == nullptr || (size_t)(line_end - buf) > kMaxHttpLine) {
        *err_status = 414;
        return -1;
    }
    const char* sp1 = (const char*)std::memchr(buf, ' ',
                                               (size_t)(line_end - buf));
    if (sp1 == nullptr) {
        *err_status = 400;
        return -1;
    }
    const char* sp2 = (const char*)std::memchr(
        sp1 + 1, ' ', (size_t)(line_end - sp1 - 1));
    if (sp2 == nullptr) {
        *err_status = 400;
        return -1;
    }
    req.method.assign(buf, (size_t)(sp1 - buf));
    req.target.assign(sp1 + 1, (size_t)(sp2 - sp1 - 1));
    const std::string version(sp2 + 1, (size_t)(line_end - sp2 - 1));
    if (version == "HTTP/1.1") {
        req.http11 = true;
    } else if (version == "HTTP/1.0") {
        req.http11 = false;
    } else {
        *err_status = 400;
        return -1;
    }
    const size_t qpos = req.target.find('?');
    req.path = (qpos == std::string::npos) ? req.target
                                           : req.target.substr(0, qpos);

    // --- header lines ---
    const char* p = line_end + 2;
    while (p < head_end + 2) {
        const char* eol = (const char*)std::memchr(
            p, '\r', (size_t)(head_end + 2 - p));
        if (eol == nullptr) eol = head_end;
        if ((size_t)(eol - p) > kMaxHttpLine ||
            req.headers.size() >= kMaxHttpHeaders) {
            *err_status = 431;
            return -1;
        }
        if (eol == p) break;
        const char* colon = (const char*)std::memchr(p, ':',
                                                     (size_t)(eol - p));
        if (colon == nullptr) {
            *err_status = 400;
            return -1;
        }
        std::string name(p, (size_t)(colon - p));
        for (char& c : name) {
            if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
        }
        const char* v = colon + 1;
        while (v < eol && (*v == ' ' || *v == '\t')) v++;
        const char* ve = eol;
        while (ve > v && (ve[-1] == ' ' || ve[-1] == '\t')) ve--;
        req.headers.emplace_back(std::move(name),
                                 std::string(v, (size_t)(ve - v)));
        p = eol + 2;
    }

    // --- derived semantics ---
    req.keep_alive = req.http11;
    const std::string conn = req.get_str("connection");
    if (!conn.empty()) {
        std::string lc = conn;
        for (char& c : lc) {
            if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
        }
        if (lc.find("close") != std::string::npos) req.keep_alive = false;
        else if (lc.find("keep-alive") != std::string::npos)
            req.keep_alive = true;
    }
    const std::string expect = req.get_str("expect");
    if (!expect.empty()) {
        std::string lc = expect;
        for (char& c : lc) {
            if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
        }
        req.expect_continue = (lc == "100-continue");
    }
    const std::string* cl = req.get("content-length");
    if (cl != nullptr) {
        req.has_content_length = true;
        req.content_length = 0;
        req.bad_content_length = cl->empty();
        for (const char c : *cl) {
            if (c < '0' || c > '9' || req.content_length > (int64_t)1 << 48) {
                req.bad_content_length = true;
                break;
            }
            req.content_length = req.content_length * 10 + (c - '0');
        }
    }
    return 1;
}

// Canonical reason phrases for the statuses this tier emits (parity tests
// normalize the phrase — CPython's own wording shifts across versions).
inline const char* http_reason(int status) {
    switch (status) {
        case 100: return "Continue";
        case 200: return "OK";
        case 400: return "Bad Request";
        case 401: return "Unauthorized";
        case 403: return "Forbidden";
        case 404: return "Not Found";
        case 411: return "Length Required";
        case 413: return "Request Entity Too Large";
        case 414: return "Request-URI Too Long";
        case 429: return "Too Many Requests";
        case 431: return "Request Header Fields Too Large";
        case 500: return "Internal Server Error";
        case 501: return "Not Implemented";
        case 502: return "Bad Gateway";
        case 503: return "Service Unavailable";
        default: return "Unknown";
    }
}

// RFC 1123 date for the Date header, e.g. "Thu, 06 Aug 2026 12:00:00 GMT".
inline void http_date(char out[40]) {
    static const char* days[] = {"Sun", "Mon", "Tue", "Wed", "Thu", "Fri",
                                 "Sat"};
    static const char* months[] = {"Jan", "Feb", "Mar", "Apr", "May", "Jun",
                                   "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"};
    time_t now = time(nullptr);
    struct tm tmv;
    gmtime_r(&now, &tmv);
    std::snprintf(out, 40, "%s, %02d %s %04d %02d:%02d:%02d GMT",
                  days[tmv.tm_wday], tmv.tm_mday, months[tmv.tm_mon],
                  tmv.tm_year + 1900, tmv.tm_hour, tmv.tm_min, tmv.tm_sec);
}

// Serialize a response head + body.  Header order mirrors the CPython
// tier's _reply: status line, Server, Date, Content-Type, Content-Length,
// extras (Retry-After / WWW-Authenticate / proxied headers), then the
// trace headers the caller appended into `extras`.
inline void http_response(std::string& out, int status, const char* ctype,
                          const char* body, size_t body_len,
                          const std::vector<std::pair<std::string,
                                                      std::string>>& extras) {
    char line[128];
    std::snprintf(line, sizeof(line), "HTTP/1.1 %d %s\r\n", status,
                  http_reason(status));
    out += line;
    out += "Server: misaka-native-edge/1\r\n";
    char date[40];
    http_date(date);
    out += "Date: ";
    out += date;
    out += "\r\n";
    if (ctype != nullptr) {
        out += "Content-Type: ";
        out += ctype;
        out += "\r\n";
    }
    std::snprintf(line, sizeof(line), "Content-Length: %zu\r\n", body_len);
    out += line;
    for (const auto& kv : extras) {
        out += kv.first;
        out += ": ";
        out += kv.second;
        out += "\r\n";
    }
    out += "\r\n";
    out.append(body, body_len);
}

// application/x-www-form-urlencoded decode with parse_qs semantics the
// engine routes rely on (keep_blank_values=True, first value wins the
// {k: v[0]} projection, '+' means space, %XX decoded).
inline void form_decode(const char* body, size_t len,
                        std::map<std::string, std::string>& out) {
    auto hexval = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
    };
    size_t i = 0;
    while (i <= len) {
        size_t amp = i;
        while (amp < len && body[amp] != '&') amp++;
        if (amp > i) {
            std::string key, val;
            std::string* cur = &key;
            for (size_t j = i; j < amp; j++) {
                const char c = body[j];
                if (c == '=' && cur == &key) {
                    cur = &val;
                } else if (c == '+') {
                    cur->push_back(' ');
                } else if (c == '%' && j + 2 < amp &&
                           hexval(body[j + 1]) >= 0 &&
                           hexval(body[j + 2]) >= 0) {
                    cur->push_back((char)(hexval(body[j + 1]) * 16 +
                                          hexval(body[j + 2])));
                    j += 2;
                } else {
                    cur->push_back(c);
                }
            }
            if (out.find(key) == out.end()) out.emplace(key, val);
        }
        if (amp >= len) break;
        i = amp + 1;
    }
}

// Percent-decode a path segment (urllib.parse.unquote: '+' stays '+').
inline std::string url_unquote(const std::string& s) {
    auto hexval = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
    };
    std::string out;
    out.reserve(s.size());
    for (size_t i = 0; i < s.size(); i++) {
        if (s[i] == '%' && i + 2 < s.size() && hexval(s[i + 1]) >= 0 &&
            hexval(s[i + 2]) >= 0) {
            out.push_back((char)(hexval(s[i + 1]) * 16 + hexval(s[i + 2])));
            i += 2;
        } else {
            out.push_back(s[i]);
        }
    }
    return out;
}

}  // namespace msk
