// Native serving edge (ISSUE 16): an epoll-driven HTTP/1.1 frontend tier
// that terminates the hot compute routes in C++ and speaks the existing
// compute-plane frame protocol straight into the engine — no GIL on the
// data path.  CPython stays the control plane: runtime/frontends.py's
// NativeFrontendSupervisor compiles this unit, starts it over the ctypes
// C API below, and pushes auth-key digests / quota specs / the program
// map as JSON snapshots (msk_edge_push_state), the way specialize.py
// pushes compiled programs.
//
// Division of authority (load-bearing — the parity tests pin it):
//  * The ENGINE-side edge chain stays the authority for every admission
//    decision that ships: each plane frame carries the request's API key
//    and the engine answers typed EdgeReject JSON that this tier renders
//    exactly like the CPython worker's _plane_error (message body,
//    Retry-After ceiling, WWW-Authenticate on 401).
//  * The native tier answers LOCALLY only what the CPython tier also
//    answers locally (shed-cache 429 replays, the plane-depth overload
//    guard) plus the two decisions the pushed state makes safe: fast
//    401s against the pushed digest table (the same 0.5s staleness the
//    engine's own KeyFile re-stat has) and the single-request
//    burst-capacity 413 for keys whose OWN quota spec pins vps.  Every
//    local rejection is billed engine-side through the frame-metadata
//    "shed" rows, so misaka_edge_* counters stay whole.
//  * Anything else — admin routes, debug surfaces, GETs, cold lanes —
//    proxies to the CPython worker tier unchanged (same 5 forwarded /
//    6 copied-back headers as FrontendHandler._proxy).
//
// Concurrency model: N worker threads (MISAKA_NATIVE_EDGE_THREADS), each
// with its own SO_REUSEPORT listener, epoll instance, connection table,
// plane connections, and shed cache — nothing crosses threads except the
// stats atomics, the pushed-state shared_ptr swap, and the span ring.

#include "msk_frame.hpp"
#include "msk_http.hpp"

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <deque>
#include <iterator>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>

namespace {

using msk::JsonValue;

inline double mono_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

inline double unix_now() {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

// ---------------------------------------------------------------------------
// Configuration + pushed state
// ---------------------------------------------------------------------------

struct Config {
    int port = 0;
    int threads = 2;
    int max_conns = 1024;
    int plane_conns = 2;
    int plane_depth_max = 256;
    int proxy_port = 0;
    int64_t max_body = 8 << 20;
    int64_t plane_body_limit = 2 << 20;
    double plane_timeout = 30.0;
    std::string plane_path;
    std::string proxy_host = "127.0.0.1";
    std::string handshake;  // raw bytes (empty = plane secret unarmed)
};

struct BurstQuota {
    double cap = 0.0;        // scaled burst capacity in values
    std::string msg_mid;     // rendered Python-side: " values exceeds ..."
    std::string tenant;
};

// Immutable control-plane snapshot; workers load it via shared_ptr so a
// push never blocks the data path.
struct PushState {
    bool auth_armed = false;
    std::unordered_set<std::string> digests;  // hex HMAC digests
    std::unordered_map<std::string, BurstQuota> bursts;
    std::string missing_msg;  // 401 body for a keyless request
    std::string unknown_msg;  // 401 body for an unknown key
    std::string healthz_body = "{\"ok\": true}\n";
    std::string healthz_ctype = "application/json";
    std::unordered_set<std::string> programs;
    bool trace_enabled = false;
    double trace_sample = 1.0;
    bool slo_armed = false;
    // the capture plane (runtime/capture.py): while the engine-side
    // recorder is armed, locally-terminated rejects (shed 429, 401, 413,
    // overload) are recorded here and drained by the supervisor — the
    // engine never sees those requests, so this tier owns their records
    bool capture_enabled = false;
    double capture_sample = 1.0;
};

struct Stats {
    std::atomic<uint64_t> conns_total{0};
    std::atomic<uint64_t> conns_open{0};
    std::atomic<uint64_t> requests{0};
    std::atomic<uint64_t> plane_shipped{0};
    std::atomic<uint64_t> proxied{0};
    std::atomic<uint64_t> plane_errors{0};
    std::atomic<uint64_t> local_401{0};
    std::atomic<uint64_t> local_413{0};
    std::atomic<uint64_t> shed_hits{0};
    std::atomic<uint64_t> overload{0};
};

struct SpanRec {
    std::string name;
    std::string lane;
    std::string trace;
    double start = 0.0;
    double dur = 0.0;
};

// one locally-terminated request the capture plane records (sampling is
// applied at record time, so drained rows ingest pre-sampled)
struct CaptureRec {
    double t = 0.0;  // unix seconds (the load-model arrival clock)
    std::string program;
    std::string trace;
    int status = 0;
    std::string reason;
};

// ---------------------------------------------------------------------------
// Per-connection state
// ---------------------------------------------------------------------------

enum class CState { Head, Body, Wait };
enum class Dispatch { None, Raw, Compute, Batch, Proxy, Discard };

struct Conn {
    int fd = -1;
    uint64_t gen = 0;
    uint32_t events = 0;  // currently-armed epoll interest
    CState st = CState::Head;
    Dispatch disp = Dispatch::None;
    bool close_after = false;
    std::string rbuf;
    std::string wbuf;
    size_t woff = 0;
    int64_t body_need = 0;

    // request context (reset per request)
    msk::HttpRequest req;
    std::string program;   // "" = default-addressed
    std::string key;       // "" = keyless
    std::string trace_id;  // "" = untraced
    bool trace_inbound = false;  // ID presented by the client (capture
                                 // sampling bypass rides this)
    bool accepts_binary = false;
    double t_start = 0.0, t_parse = 0.0, d_parse = 0.0;

    // deferred reply for drain-then-answer paths (shed-cache hits)
    bool have_deferred = false;
    int deferred_status = 0;
    std::string deferred_body;
    std::vector<std::pair<std::string, std::string>> deferred_extras;

    // proxy upstream
    int upfd = -1;
    bool up_reused = false;
    bool up_connecting = false;
    int up_attempts = 0;
    std::string up_req;   // full serialized upstream request (for retry)
    size_t up_woff = 0;
    std::string up_rbuf;
    size_t up_head_end = 0;
    int64_t up_body_need = -1;  // -1 head pending, -2 read-to-EOF
};

struct PlanePending {
    uint32_t slot = 0;
    uint64_t gen = 0;
    Dispatch kind = Dispatch::Raw;
    bool accepts_binary = false;
    bool zombie = false;
    double deadline = 0.0;
    double t_ship = 0.0;
    double t_req_start = 0.0;
    std::string trace_id;
    std::string shed_program;
    std::string shed_key;
};

struct PlaneConn {
    int fd = -1;
    uint32_t events = 0;
    std::string wbuf;
    size_t woff = 0;
    std::string rbuf;
    std::deque<PlanePending> pending;
    double reconnect_at = 0.0;
};

struct ShedEntry {
    double until = 0.0;
    std::string message;
    std::string tenant;  // "" = no tenant label
    bool has_tenant = false;
    std::string reason;
};

struct Engine;

// epoll tag kinds packed into event.data.u64 as (kind << 48) | index
enum : uint64_t { K_LISTEN = 1, K_WAKE = 2, K_CLIENT = 3, K_PLANE = 4,
                  K_UP = 5 };

struct Worker {
    Engine* eng = nullptr;
    int idx = 0;
    int ep = -1;
    int listen_fd = -1;
    int wake_fd = -1;
    std::string lane;
    uint64_t rng = 0;
    std::vector<std::unique_ptr<Conn>> slots;
    std::vector<uint32_t> free_slots;
    uint64_t next_gen = 1;
    std::vector<PlaneConn> planes;
    std::unordered_map<std::string, ShedEntry> shed;
    std::unordered_map<std::string, uint64_t> shed_rows;  // tenant\0reason
    double next_housekeep = 0.0;

    void run();
    void tick_housekeeping(double now);
    // clients
    void on_accept();
    Conn* conn_at(uint32_t slot, uint64_t gen);
    void close_conn(uint32_t slot);
    void update_events(uint32_t slot);
    void flush_conn(uint32_t slot);
    void on_client_io(uint32_t slot, uint32_t evmask);
    void process(uint32_t slot);
    void handle_head(uint32_t slot);
    void dispatch_body(uint32_t slot, std::string&& body);
    void reply(uint32_t slot, int status, const char* ctype,
               const std::string& body,
               std::vector<std::pair<std::string, std::string>> extras,
               bool add_trace);
    void reply_text(uint32_t slot, int status, const std::string& body,
                    std::vector<std::pair<std::string, std::string>> extras);
    void finish_request(uint32_t slot);
    // plane
    bool ensure_plane(size_t i, double now);
    void ship_frame(uint32_t slot, Dispatch kind, const std::string& payload);
    void flush_plane(size_t i);
    void on_plane_io(size_t i, uint32_t evmask);
    void plane_fail_all(size_t i, const char* why);
    void complete_pending(PlanePending& p, int status,
                          const char* body, size_t body_len);
    void plane_error_reply(uint32_t slot, const PlanePending& p, int status,
                           const std::string& body);
    // proxy
    void start_proxy(uint32_t slot, const std::string& body);
    void start_proxy_post(uint32_t slot);
    bool up_connect(uint32_t slot);
    void up_send(uint32_t slot);
    void on_up_io(uint32_t slot, uint32_t evmask);
    void up_fail(uint32_t slot, const char* why);
    void up_deliver(uint32_t slot);
    void close_up(Conn& c);
    // shed + spans + misc
    void shed_row(const std::string& tenant, bool has_tenant,
                  const char* reason);
    void record_span(const char* name, double start, double dur,
                     const std::string& trace);
    void record_capture(const PushState& st, const Conn& c, int status,
                        const char* reason);
    std::string mint_trace();
    int depth() const;
};

struct Engine {
    Config cfg;
    Stats stats;
    std::atomic<bool> stopping{false};
    std::atomic<int> plane_depth{0};
    std::vector<std::thread> threads;
    std::vector<Worker> workers;
    std::vector<int> listeners;
    int actual_port = 0;

    std::mutex state_mu;
    std::shared_ptr<const PushState> state{std::make_shared<PushState>()};

    std::mutex span_mu;
    std::deque<SpanRec> spans;

    std::mutex cap_mu;
    std::deque<CaptureRec> caps;
    uint64_t caps_dropped = 0;  // ring overflow (guarded by cap_mu)

    std::shared_ptr<const PushState> load_state() {
        std::lock_guard<std::mutex> g(state_mu);
        return state;
    }
};

std::mutex g_api_mu;
Engine* g_engine = nullptr;
std::string g_last_error;

// ---------------------------------------------------------------------------
// Small helpers
// ---------------------------------------------------------------------------

void ep_add(int ep, int fd, uint64_t tag, uint32_t events) {
    struct epoll_event ev;
    ev.events = events;
    ev.data.u64 = tag;
    epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev);
}

void ep_mod(int ep, int fd, uint64_t tag, uint32_t events) {
    struct epoll_event ev;
    ev.events = events;
    ev.data.u64 = tag;
    epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ev);
}

// str(max(1, ceil(x))) — the CPython tier's Retry-After rendering
std::string retry_after_header(double x) {
    long long v = (long long)std::ceil(x);
    if (v < 1) v = 1;
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%lld", v);
    return buf;
}

const char kTextCType[] = "text/plain; charset=utf-8";
const char kWwwAuth[] = "Bearer realm=\"misaka\", charset=\"UTF-8\"";

}  // namespace

// ---------------------------------------------------------------------------
// Worker: event loop
// ---------------------------------------------------------------------------

namespace {

void Worker::run() {
    ep = epoll_create1(EPOLL_CLOEXEC);
    ep_add(ep, listen_fd, (K_LISTEN << 48), EPOLLIN);
    ep_add(ep, wake_fd, (K_WAKE << 48), EPOLLIN);
    planes.resize((size_t)eng->cfg.plane_conns);
    char lbuf[32];
    std::snprintf(lbuf, sizeof(lbuf), "edge-t%d", idx);
    lane = lbuf;
    rng = 0x9e3779b97f4a7c15ull * (uint64_t)(idx + 1) ^
          (uint64_t)::getpid() << 17 ^ (uint64_t)(mono_now() * 1e9);

    struct epoll_event evs[128];
    while (!eng->stopping.load(std::memory_order_relaxed)) {
        const int n = epoll_wait(ep, evs, 128, 100);
        if (eng->stopping.load(std::memory_order_relaxed)) break;
        for (int i = 0; i < n; i++) {
            const uint64_t tag = evs[i].data.u64;
            const uint64_t kind = tag >> 48;
            const uint32_t id = (uint32_t)(tag & 0xffffffffu);
            const uint32_t em = evs[i].events;
            switch (kind) {
                case K_LISTEN: on_accept(); break;
                case K_WAKE: {
                    uint64_t junk;
                    ssize_t r = read(wake_fd, &junk, 8);
                    (void)r;
                    break;
                }
                case K_CLIENT: on_client_io(id, em); break;
                case K_PLANE: on_plane_io(id, em); break;
                case K_UP: on_up_io(id, em); break;
                default: break;
            }
        }
        const double now = mono_now();
        if (now >= next_housekeep) {
            tick_housekeeping(now);
            next_housekeep = now + 0.05;
        }
    }
    // teardown: close everything this worker owns.  wake_fd is NOT ours
    // to close — the stopper may still be write()ing it (it nudges every
    // worker, including ones that already noticed `stopping` on the poll
    // timeout); msk_edge_stop closes it after the join.
    for (uint32_t s = 0; s < slots.size(); s++) {
        if (slots[s]) close_conn(s);
    }
    for (auto& pc : planes) {
        if (pc.fd >= 0) close(pc.fd);
    }
    close(ep);
}

void Worker::tick_housekeeping(double now) {
    // plane frame deadlines: FIFO, so only the front of each queue can
    // time out first; zombies stay queued to keep response pairing
    for (size_t i = 0; i < planes.size(); i++) {
        PlaneConn& pc = planes[i];
        for (auto& p : pc.pending) {
            if (p.zombie || p.deadline > now) continue;
            p.zombie = true;
            eng->plane_depth.fetch_sub(1, std::memory_order_relaxed);
            eng->stats.plane_errors.fetch_add(1, std::memory_order_relaxed);
            Conn* c = conn_at(p.slot, p.gen);
            if (c != nullptr) {
                reply_text(p.slot, 500, "compute plane timed out", {});
                finish_request(p.slot);
            }
        }
    }
    // shed-cache hygiene: CPython sweeps expired past 1024 entries and
    // hard-caps at 4096
    if (shed.size() > 1024) {
        for (auto it = shed.begin(); it != shed.end();) {
            it = (it->second.until <= now) ? shed.erase(it) : std::next(it);
        }
        if (shed.size() > 4096) shed.clear();
    }
}

int Worker::depth() const {
    return eng->plane_depth.load(std::memory_order_relaxed);
}

std::string Worker::mint_trace() {
    // xorshift64* — cheap per-thread IDs, 16 hex chars like uuid4().hex[:16]
    rng ^= rng >> 12;
    rng ^= rng << 25;
    rng ^= rng >> 27;
    const uint64_t v = rng * 0x2545F4914F6CDD1Dull;
    char buf[24];
    std::snprintf(buf, sizeof(buf), "%016llx", (unsigned long long)v);
    return buf;
}

void Worker::record_span(const char* name, double start, double dur,
                         const std::string& trace) {
    std::lock_guard<std::mutex> g(eng->span_mu);
    if (eng->spans.size() >= 2048) eng->spans.pop_front();
    eng->spans.push_back(SpanRec{name, lane, trace, start, dur});
}

void Worker::record_capture(const PushState& st, const Conn& c, int status,
                            const char* reason) {
    if (!st.capture_enabled) return;
    // MISAKA_CAPTURE_SAMPLE applied HERE (rows ingest pre-sampled); an
    // inbound X-Misaka-Trace bypasses sampling, like the engine recorder
    if (!c.trace_inbound && st.capture_sample < 1.0) {
        rng ^= rng >> 12;
        rng ^= rng << 25;
        rng ^= rng >> 27;
        const double u =
            (double)(rng * 0x2545F4914F6CDD1Dull >> 11) * 0x1.0p-53;
        if (u >= st.capture_sample) return;
    }
    std::lock_guard<std::mutex> g(eng->cap_mu);
    if (eng->caps.size() >= 1024) {
        eng->caps.pop_front();
        eng->caps_dropped++;
    }
    eng->caps.push_back(
        CaptureRec{unix_now(), c.program, c.trace_id, status, reason});
}

void Worker::shed_row(const std::string& tenant, bool has_tenant,
                      const char* reason) {
    std::string k = has_tenant ? tenant : std::string("\x01");
    k.push_back('\0');
    k += reason;
    shed_rows[k] += 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// Worker: client connections
// ---------------------------------------------------------------------------

namespace {

void Worker::on_accept() {
    while (true) {
        const int fd = accept4(listen_fd, nullptr, nullptr,
                               SOCK_NONBLOCK | SOCK_CLOEXEC);
        if (fd < 0) return;
        if ((int)eng->stats.conns_open.load(std::memory_order_relaxed) >=
            eng->cfg.max_conns) {
            close(fd);
            continue;
        }
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        uint32_t slot;
        if (!free_slots.empty()) {
            slot = free_slots.back();
            free_slots.pop_back();
        } else {
            slot = (uint32_t)slots.size();
            slots.emplace_back();
        }
        slots[slot] = std::make_unique<Conn>();
        Conn& c = *slots[slot];
        c.fd = fd;
        c.gen = next_gen++;
        c.events = EPOLLIN;
        ep_add(ep, fd, (K_CLIENT << 48) | slot, EPOLLIN);
        eng->stats.conns_total.fetch_add(1, std::memory_order_relaxed);
        eng->stats.conns_open.fetch_add(1, std::memory_order_relaxed);
    }
}

Conn* Worker::conn_at(uint32_t slot, uint64_t gen) {
    if (slot >= slots.size() || !slots[slot]) return nullptr;
    return slots[slot]->gen == gen ? slots[slot].get() : nullptr;
}

void Worker::close_conn(uint32_t slot) {
    Conn& c = *slots[slot];
    close_up(c);
    close(c.fd);
    slots[slot].reset();
    free_slots.push_back(slot);
    eng->stats.conns_open.fetch_sub(1, std::memory_order_relaxed);
}

void Worker::update_events(uint32_t slot) {
    Conn& c = *slots[slot];
    uint32_t want = 0;
    // natural backpressure: stop reading while a response is pending or
    // the write buffer is deep
    if (c.st != CState::Wait && c.wbuf.size() - c.woff < (512u << 10)) {
        want |= EPOLLIN;
    }
    if (c.woff < c.wbuf.size()) want |= EPOLLOUT;
    if (want != c.events) {
        ep_mod(ep, c.fd, (K_CLIENT << 48) | slot, want);
        c.events = want;
    }
}

void Worker::flush_conn(uint32_t slot) {
    Conn& c = *slots[slot];
    while (c.woff < c.wbuf.size()) {
        const ssize_t n = send(c.fd, c.wbuf.data() + c.woff,
                               c.wbuf.size() - c.woff, MSG_NOSIGNAL);
        if (n > 0) {
            c.woff += (size_t)n;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        close_conn(slot);
        return;
    }
    if (c.woff >= c.wbuf.size()) {
        c.wbuf.clear();
        c.woff = 0;
        if (c.close_after) {
            close_conn(slot);
            return;
        }
    }
    update_events(slot);
}

void Worker::on_client_io(uint32_t slot, uint32_t evmask) {
    if (slot >= slots.size() || !slots[slot]) return;
    if (evmask & (EPOLLHUP | EPOLLERR)) {
        close_conn(slot);
        return;
    }
    Conn& c = *slots[slot];
    if (evmask & EPOLLIN) {
        char buf[16384];
        while (true) {
            const ssize_t n = recv(c.fd, buf, sizeof(buf), 0);
            if (n > 0) {
                c.rbuf.append(buf, (size_t)n);
                if (c.rbuf.size() > (1u << 20) + (size_t)eng->cfg.max_body) {
                    close_conn(slot);  // pipelined flood guard
                    return;
                }
                if (n < (ssize_t)sizeof(buf)) break;
                continue;
            }
            if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
            close_conn(slot);
            return;
        }
        process(slot);
        if (slot >= slots.size() || !slots[slot]) return;
    }
    if ((evmask & EPOLLOUT) && slots[slot]) flush_conn(slot);
}

// Advance the per-connection state machine as far as the buffered bytes
// allow.  Leaves Wait states alone: a plane / upstream completion will
// re-enter via finish_request.
void Worker::process(uint32_t slot) {
    while (slots[slot]) {
        Conn& c = *slots[slot];
        if (c.close_after || c.st == CState::Wait) break;
        if (c.st == CState::Head) {
            if (c.rbuf.empty()) break;
            c.req = msk::HttpRequest();
            int err_status = 0;
            const int r = msk::http_parse_request(c.rbuf.data(),
                                                  c.rbuf.size(), c.req,
                                                  &err_status);
            if (r == 0) break;
            if (r < 0) {
                c.trace_id.clear();
                reply_text(slot, err_status, "request rejected", {});
                slots[slot]->close_after = true;
                flush_conn(slot);
                return;
            }
            c.t_parse = mono_now();
            c.rbuf.erase(0, c.req.header_bytes);
            handle_head(slot);
            continue;
        }
        // CState::Body
        if ((int64_t)c.rbuf.size() < c.body_need) break;
        std::string body = c.rbuf.substr(0, (size_t)c.body_need);
        c.rbuf.erase(0, (size_t)c.body_need);
        c.body_need = 0;
        dispatch_body(slot, std::move(body));
    }
    if (slots[slot]) {
        flush_conn(slot);
    }
}

void Worker::reply(uint32_t slot, int status, const char* ctype,
                   const std::string& body,
                   std::vector<std::pair<std::string, std::string>> extras,
                   bool add_trace) {
    Conn& c = *slots[slot];
    if (add_trace && !c.trace_id.empty()) {
        bool have = false;
        for (const auto& kv : extras) {
            if (kv.first == "X-Misaka-Trace") have = true;
        }
        if (!have) {
            extras.emplace_back("X-Misaka-Trace", c.trace_id);
            char tbuf[48];
            std::snprintf(tbuf, sizeof(tbuf), "total;dur=%.1f",
                          (mono_now() - c.t_start) * 1000.0);
            extras.emplace_back("Server-Timing", tbuf);
        }
    }
    msk::http_response(c.wbuf, status, ctype, body.data(), body.size(),
                       extras);
    if (!c.req.keep_alive) c.close_after = true;
}

void Worker::reply_text(uint32_t slot, int status, const std::string& body,
                        std::vector<std::pair<std::string, std::string>>
                            extras) {
    reply(slot, status, kTextCType, body, std::move(extras), true);
}

// A terminated request finished (success or typed error): rearm the
// connection for the next pipelined request.
void Worker::finish_request(uint32_t slot) {
    Conn& c = *slots[slot];
    c.st = CState::Head;
    c.disp = Dispatch::None;
    process(slot);
    if (slots[slot]) update_events(slot);
}

}  // namespace

// ---------------------------------------------------------------------------
// Worker: request routing
// ---------------------------------------------------------------------------

namespace {

// "/programs/<name>/(compute|compute_batch|compute_raw)" — the same
// shape _PROGRAM_COMPUTE_RE matches (one non-empty, slash-free segment)
bool match_program_route(const std::string& path, std::string& name,
                         std::string& op) {
    static const char prefix[] = "/programs/";
    if (path.compare(0, sizeof(prefix) - 1, prefix) != 0) return false;
    const size_t nstart = sizeof(prefix) - 1;
    const size_t slash = path.find('/', nstart);
    if (slash == std::string::npos || slash == nstart) return false;
    op = path.substr(slash + 1);
    if (op != "compute" && op != "compute_batch" && op != "compute_raw") {
        return false;
    }
    if (op.find('/') != std::string::npos) return false;
    name = msk::url_unquote(path.substr(nstart, slash - nstart));
    return true;
}

void Worker::handle_head(uint32_t slot) {
    Conn& c = *slots[slot];
    auto st = eng->load_state();
    eng->stats.requests.fetch_add(1, std::memory_order_relaxed);
    c.t_start = c.t_parse;
    c.d_parse = 0.0;
    c.program.clear();
    c.key.clear();
    c.trace_id.clear();
    c.trace_inbound = false;
    c.have_deferred = false;
    c.accepts_binary = false;

    // trace identity: honor a well-formed inbound X-Misaka-Trace
    // unconditionally (inbound IDs skip sampling, like tracespan.begin);
    // mint for a sampled share of the rest.  The capture plane also
    // needs the inbound check (its sampling bypass) even with tracing
    // disabled.
    if (st->trace_enabled || st->capture_enabled) {
        const std::string inbound = c.req.get_str("x-misaka-trace");
        bool ok = inbound.size() >= 4 && inbound.size() <= 64;
        for (const char ch : inbound) {
            if (!((ch >= '0' && ch <= '9') || (ch >= 'a' && ch <= 'z') ||
                  (ch >= 'A' && ch <= 'Z') || ch == '-')) {
                ok = false;
                break;
            }
        }
        if (ok && !inbound.empty()) {
            c.trace_id = inbound;
            c.trace_inbound = true;
        } else if (st->trace_enabled && st->trace_sample > 0.0) {
            rng ^= rng >> 12;
            rng ^= rng << 25;
            rng ^= rng >> 27;
            const double u =
                (double)(rng * 0x2545F4914F6CDD1Dull >> 11) * 0x1.0p-53;
            if (u < st->trace_sample) c.trace_id = mint_trace();
        }
    }

    if (c.req.method != "GET" && c.req.method != "POST") {
        reply_text(slot, 501, "unsupported method", {});
        c.close_after = true;
        return;
    }

    if (c.req.expect_continue && c.req.method == "POST") {
        c.wbuf += "HTTP/1.1 100 Continue\r\n\r\n";
    }

    if (c.req.method == "GET") {
        if (c.req.path == "/healthz") {
            c.d_parse = mono_now() - c.t_parse;
            reply(slot, 200, st->healthz_ctype.c_str(), st->healthz_body,
                  {}, true);
            if (!c.trace_id.empty()) {
                record_span("frontend.request", c.t_start,
                            mono_now() - c.t_start, c.trace_id);
            }
            return;  // stays in Head state; process() continues
        }
        start_proxy(slot, std::string());
        return;
    }

    // ---- POST ----
    std::string op;
    std::string prog_name;
    const bool program_route = match_program_route(c.req.path, prog_name, op);
    std::string route = c.req.path;
    if (program_route) {
        c.program = prog_name;
        route = "/" + op;
    } else {
        c.program = c.req.get_str("x-misaka-program");
    }
    // key: X-Misaka-Key wins, else a Bearer Authorization
    c.key = c.req.get_str("x-misaka-key");
    if (c.key.empty()) {
        const std::string auth = c.req.get_str("authorization");
        if (auth.compare(0, 7, "Bearer ") == 0) {
            std::string k = auth.substr(7);
            while (!k.empty() && (k.front() == ' ' || k.front() == '\t')) {
                k.erase(k.begin());
            }
            while (!k.empty() && (k.back() == ' ' || k.back() == '\t')) {
                k.pop_back();
            }
            c.key = k;
        }
    }

    const bool hot = route == "/compute_raw" || route == "/compute" ||
                     route == "/compute_batch";
    if (!hot) {
        start_proxy_post(slot);
        return;
    }

    // /compute_batch: terminate only the coalesced default lane the plane
    // already implements; the spread lane and cold (unpushed) programs
    // proxy to the CPython tier unchanged
    if (route == "/compute_batch" &&
        !c.program.empty() && st->programs.count(c.program) == 0) {
        start_proxy_post(slot);
        return;
    }
    // the raw spread escape hatch keeps the CPython semantics
    if (route == "/compute_raw" &&
        c.req.target.find("spread=0") != std::string::npos) {
        start_proxy_post(slot);
        return;
    }

    // shed cache: replay a recent engine-side 429 without shipping
    std::string shed_key = c.program;
    shed_key.push_back('\0');
    shed_key += c.key;
    auto sit = shed.find(shed_key);
    if (sit != shed.end()) {
        const double now = mono_now();
        if (sit->second.until > now) {
            eng->stats.shed_hits.fetch_add(1, std::memory_order_relaxed);
            shed_row(sit->second.tenant, sit->second.has_tenant,
                     sit->second.reason.c_str());
            record_capture(*st, c, 429, sit->second.reason.c_str());
            c.have_deferred = true;
            c.deferred_status = 429;
            c.deferred_body = sit->second.message;
            c.deferred_extras = {
                {"Retry-After", retry_after_header(sit->second.until - now)}};
            // drain_or_close: consume a small body, else close on it
            if (c.req.has_content_length && !c.req.bad_content_length &&
                c.req.content_length <= 65536) {
                c.st = CState::Body;
                c.disp = Dispatch::Discard;
                c.body_need = c.req.content_length;
            } else {
                reply_text(slot, 429, c.deferred_body, c.deferred_extras);
                c.have_deferred = false;
                c.close_after = true;
            }
            return;
        }
        shed.erase(sit);
    }

    // plane-depth admission guard (the CPython tier's _edge_guard)
    if (eng->cfg.plane_depth_max > 0 && depth() >= eng->cfg.plane_depth_max) {
        eng->stats.overload.fetch_add(1, std::memory_order_relaxed);
        shed_row(std::string(), false, "overload");
        record_capture(*st, c, 429, "overload");
        char msg[160];
        std::snprintf(msg, sizeof(msg),
                      "frontend overloaded: %d plane frames queued (cap %d); "
                      "retry after backoff",
                      depth(), eng->cfg.plane_depth_max);
        reply_text(slot, 429, msg, {{"Retry-After", "1"}});
        c.close_after = true;
        return;
    }

    if (route == "/compute_raw") {
        c.accepts_binary = msk::wire_accepts_binary(c.req.get_str("accept"));
        // oversized-for-the-plane bodies proxy; the engine's own cap
        // answers the canonical 413
        if (c.req.has_content_length && !c.req.bad_content_length &&
            c.req.content_length > eng->cfg.plane_body_limit) {
            start_proxy_post(slot);
            return;
        }
        if (!c.req.has_content_length) {
            reply_text(slot, 411, "Content-Length required", {});
            c.close_after = true;
            return;
        }
        if (c.req.bad_content_length) {
            reply_text(slot, 400, "cannot parse Content-Length", {});
            c.close_after = true;
            return;
        }
        if (c.req.content_length > eng->cfg.max_body) {
            char msg[160];
            std::snprintf(msg, sizeof(msg),
                          "body of %lld bytes exceeds the %lld-byte cap "
                          "(MISAKA_MAX_BODY)",
                          (long long)c.req.content_length,
                          (long long)eng->cfg.max_body);
            reply_text(slot, 413, msg, {});
            c.close_after = true;
            return;
        }
        c.st = CState::Body;
        c.disp = Dispatch::Raw;
        c.body_need = c.req.content_length;
        return;
    }

    // /compute and /compute_batch: form bodies, Content-Length optional
    // (an absent length is an empty form, the _read_body(required=False)
    // contract)
    if (c.req.has_content_length && c.req.bad_content_length) {
        reply_text(slot, 400, "cannot parse Content-Length", {});
        c.close_after = true;
        return;
    }
    if (c.req.has_content_length &&
        c.req.content_length > eng->cfg.max_body) {
        char msg[160];
        std::snprintf(msg, sizeof(msg),
                      "body of %lld bytes exceeds the %lld-byte cap "
                      "(MISAKA_MAX_BODY)",
                      (long long)c.req.content_length,
                      (long long)eng->cfg.max_body);
        reply_text(slot, 413, msg, {});
        c.close_after = true;
        return;
    }
    c.st = CState::Body;
    c.disp = route == "/compute" ? Dispatch::Compute : Dispatch::Batch;
    c.body_need = c.req.has_content_length ? c.req.content_length : 0;
}

void Worker::dispatch_body(uint32_t slot, std::string&& body) {
    Conn& c = *slots[slot];
    auto st = eng->load_state();
    c.st = CState::Head;
    const Dispatch disp = c.disp;
    c.disp = Dispatch::None;

    if (disp == Dispatch::Discard) {
        // drained a shed-cache hit's body; answer the held reply
        reply_text(slot, c.deferred_status, c.deferred_body,
                   c.deferred_extras);
        c.have_deferred = false;
        return;
    }
    if (disp == Dispatch::Proxy) {
        start_proxy(slot, body);
        return;
    }

    c.d_parse = mono_now() - c.t_parse;

    // local fast-401 against the pushed digest table (same decision, and
    // same staleness window, as the engine's KeyFile); billed through the
    // frame-metadata shed rows of the next shipped frame
    auto local_401 = [&](const std::string& msg) {
        eng->stats.local_401.fetch_add(1, std::memory_order_relaxed);
        shed_row(std::string(), false, "unauthenticated");
        record_capture(*st, c, 401, "unauthenticated");
        reply_text(slot, 401, msg,
                   {{"WWW-Authenticate", kWwwAuth}});
    };
    const bool key_known =
        !st->auth_armed ||
        (!c.key.empty() &&
         st->digests.count(msk::api_key_digest_hex(c.key)) != 0);

    if (disp == Dispatch::Raw) {
        const uint8_t* payload = (const uint8_t*)body.data();
        size_t payload_len = body.size();
        if (msk::wire_is_binary(c.req.get_str("content-type"))) {
            std::string werr;
            if (!msk::wire_unpack((const uint8_t*)body.data(), body.size(),
                                  &payload, &payload_len, werr)) {
                reply_text(slot, 400, "bad binary body: " + werr, {});
                return;
            }
        } else if (body.size() % 4 != 0) {
            reply_text(slot, 400, "body must be raw int32 values", {});
            return;
        }
        if (st->auth_armed && c.key.empty()) {
            local_401(st->missing_msg);
            return;
        }
        if (st->auth_armed && !key_known) {
            local_401(st->unknown_msg);
            return;
        }
        // single-request burst 413 for keys whose own spec pins vps —
        // the engine would reject this frame identically; answering here
        // skips shipping a doomed megabyte
        if (st->auth_armed && !c.key.empty()) {
            auto bit = st->bursts.find(msk::api_key_digest_hex(c.key));
            if (bit != st->bursts.end() &&
                (double)(payload_len / 4) > bit->second.cap) {
                eng->stats.local_413.fetch_add(1, std::memory_order_relaxed);
                shed_row(bit->second.tenant, true, "values");
                record_capture(*st, c, 413, "values");
                char head[48];
                std::snprintf(head, sizeof(head), "request of %zu",
                              payload_len / 4);
                reply_text(slot, 413, head + bit->second.msg_mid, {});
                return;
            }
        }
        ship_frame(slot, Dispatch::Raw,
                   std::string((const char*)payload, payload_len));
        return;
    }

    if (disp == Dispatch::Compute) {
        std::map<std::string, std::string> form;
        msk::form_decode(body.data(), body.size(), form);
        const auto vit = form.find("value");
        bool ok = vit != form.end() && !vit->second.empty();
        int64_t value = 0;
        if (ok) {
            const char* s = vit->second.c_str();
            char* endp = nullptr;
            errno = 0;
            value = std::strtoll(s, &endp, 10);
            while (endp != nullptr && (*endp == ' ' || *endp == '\t')) endp++;
            ok = endp != nullptr && *endp == '\0' && errno == 0 &&
                 value >= INT32_MIN && value <= INT32_MAX;
        }
        if (!ok) {
            reply_text(slot, 400, "cannot parse value", {});
            return;
        }
        if (st->auth_armed && c.key.empty()) {
            local_401(st->missing_msg);
            return;
        }
        if (st->auth_armed && !key_known) {
            local_401(st->unknown_msg);
            return;
        }
        const int32_t v32 = (int32_t)value;
        ship_frame(slot, Dispatch::Compute,
                   std::string((const char*)&v32, 4));
        return;
    }

    // Dispatch::Batch — terminate only the coalesced lane (spread=1);
    // everything else keeps the CPython tier's exact semantics via proxy
    std::map<std::string, std::string> form;
    msk::form_decode(body.data(), body.size(), form);
    const auto spread = form.find("spread");
    if (spread == form.end() || spread->second != "1") {
        start_proxy(slot, body);
        return;
    }
    if (st->auth_armed && c.key.empty()) {
        local_401(st->missing_msg);
        return;
    }
    if (st->auth_armed && !key_known) {
        local_401(st->unknown_msg);
        return;
    }
    const auto vals = form.find("values");
    std::vector<int32_t> values;
    if (vals == form.end() ||
        !msk::parse_i32(vals->second.data(), vals->second.size(), values)) {
        reply_text(slot, 400, "cannot parse values", {});
        return;
    }
    ship_frame(slot, Dispatch::Batch,
               std::string((const char*)values.data(), values.size() * 4));
}

}  // namespace

// ---------------------------------------------------------------------------
// Worker: compute plane client
// ---------------------------------------------------------------------------

namespace {

bool Worker::ensure_plane(size_t i, double now) {
    PlaneConn& pc = planes[i];
    if (pc.fd >= 0) return true;
    if (now < pc.reconnect_at) return false;
    const int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC,
                          0);
    if (fd < 0) return false;
    struct sockaddr_un addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s",
                  eng->cfg.plane_path.c_str());
    if (connect(fd, (struct sockaddr*)&addr, sizeof(addr)) < 0 &&
        errno != EINPROGRESS) {
        close(fd);
        pc.reconnect_at = now + 0.05;
        return false;
    }
    pc.fd = fd;
    pc.events = EPOLLIN;
    pc.wbuf = eng->cfg.handshake;  // 32 secret bytes, or empty
    pc.woff = 0;
    pc.rbuf.clear();
    ep_add(ep, fd, (K_PLANE << 48) | (uint64_t)i, EPOLLIN);
    flush_plane(i);
    return pc.fd >= 0;
}

void Worker::flush_plane(size_t i) {
    PlaneConn& pc = planes[i];
    while (pc.woff < pc.wbuf.size()) {
        const ssize_t n = send(pc.fd, pc.wbuf.data() + pc.woff,
                               pc.wbuf.size() - pc.woff, MSG_NOSIGNAL);
        if (n > 0) {
            pc.woff += (size_t)n;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        if (n < 0 && errno == ENOTCONN) break;  // connect still in flight
        plane_fail_all(i, strerror(errno));
        return;
    }
    if (pc.woff >= pc.wbuf.size()) {
        pc.wbuf.clear();
        pc.woff = 0;
    }
    const uint32_t want =
        EPOLLIN | (pc.wbuf.empty() ? 0u : (uint32_t)EPOLLOUT);
    if (want != pc.events) {
        ep_mod(ep, pc.fd, (K_PLANE << 48) | (uint64_t)i, want);
        pc.events = want;
    }
}

void Worker::ship_frame(uint32_t slot, Dispatch kind,
                        const std::string& payload) {
    Conn& c = *slots[slot];
    auto st = eng->load_state();
    const double now = mono_now();

    // least-loaded live plane connection
    int best = -1;
    for (size_t i = 0; i < planes.size(); i++) {
        if (!ensure_plane(i, now)) continue;
        if (best < 0 || planes[i].pending.size() <
                            planes[(size_t)best].pending.size()) {
            best = (int)i;
        }
    }
    if (best < 0) {
        eng->stats.plane_errors.fetch_add(1, std::memory_order_relaxed);
        reply_text(slot, 502, "compute plane error: unavailable", {});
        return;
    }
    PlaneConn& pc = planes[(size_t)best];

    // frame metadata: the exact object PlaneClient ships — program, the
    // forwarded trace segment, the API key, SLO edge timestamps, and any
    // locally-billed shed rows
    std::string meta = "{\"program\": ";
    if (c.program.empty()) {
        meta += "null";
    } else {
        msk::json_append_str(meta, c.program);
    }
    meta += ", \"traces\": [";
    if (!c.trace_id.empty() && st->trace_enabled) {
        meta += "{\"id\": ";
        msk::json_append_str(meta, c.trace_id);
        if (c.trace_inbound) {
            // the client presented this ID: the engine-side capture
            // recorder bypasses sampling for it
            meta += ", \"in\": 1";
        }
        char sp[192];
        std::snprintf(sp, sizeof(sp),
                      ", \"spans\": [[\"http.parse\", %.9f, %.9f], "
                      "[\"frontend.edge\", %.9f, %.9f]]}",
                      c.t_parse, c.d_parse, c.t_start, now - c.t_start);
        meta += sp;
    }
    meta += "]";
    if (!c.key.empty()) {
        meta += ", \"key\": ";
        msk::json_append_str(meta, c.key);
    }
    if (st->slo_armed) {
        char eb[48];
        std::snprintf(eb, sizeof(eb), ", \"edge\": [%.6f]", c.t_start);
        meta += eb;
    }
    if (!shed_rows.empty()) {
        meta += ", \"shed\": [";
        bool first = true;
        for (const auto& kv : shed_rows) {
            const size_t nul = kv.first.find('\0');
            const std::string tenant = kv.first.substr(0, nul);
            const std::string reason = kv.first.substr(nul + 1);
            if (!first) meta += ", ";
            first = false;
            meta += "[";
            if (tenant == "\x01") {
                meta += "null";
            } else {
                msk::json_append_str(meta, tenant);
            }
            meta += ", ";
            msk::json_append_str(meta, reason);
            char nb[32];
            std::snprintf(nb, sizeof(nb), ", %llu]",
                          (unsigned long long)kv.second);
            meta += nb;
        }
        meta += "]";
        shed_rows.clear();
    }
    meta += "}";

    uint8_t hdr[msk::kPlaneReqHeaderLen];
    msk::plane_req_header((uint32_t)(payload.size() / 4),
                          (uint32_t)meta.size(), hdr);
    pc.wbuf.append((const char*)hdr, sizeof(hdr));
    pc.wbuf += payload;
    pc.wbuf += meta;

    PlanePending p;
    p.slot = slot;
    p.gen = c.gen;
    p.kind = kind;
    p.accepts_binary = c.accepts_binary;
    p.deadline = now + eng->cfg.plane_timeout;
    p.t_ship = now;
    p.t_req_start = c.t_start;
    p.trace_id = c.trace_id;
    p.shed_program = c.program;
    p.shed_key = c.key;
    pc.pending.push_back(std::move(p));
    eng->plane_depth.fetch_add(1, std::memory_order_relaxed);
    eng->stats.plane_shipped.fetch_add(1, std::memory_order_relaxed);

    c.st = CState::Wait;
    // flush may fail the connection and re-enter this conn via
    // plane_fail_all -> finish_request; re-check the slot after
    flush_plane((size_t)best);
    if (slot < slots.size() && slots[slot]) update_events(slot);
}

void Worker::on_plane_io(size_t i, uint32_t evmask) {
    PlaneConn& pc = planes[i];
    if (pc.fd < 0) return;
    if (evmask & (EPOLLHUP | EPOLLERR)) {
        plane_fail_all(i, "connection reset");
        return;
    }
    if (evmask & EPOLLOUT) flush_plane(i);
    if (pc.fd < 0 || !(evmask & EPOLLIN)) return;
    char buf[65536];
    while (true) {
        const ssize_t n = recv(pc.fd, buf, sizeof(buf), 0);
        if (n > 0) {
            pc.rbuf.append(buf, (size_t)n);
            if (n < (ssize_t)sizeof(buf)) break;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        plane_fail_all(i, n == 0 ? "connection closed" : strerror(errno));
        return;
    }
    size_t off = 0;
    while (pc.rbuf.size() - off >= msk::kPlaneRespHeaderLen) {
        int32_t status;
        uint32_t length;
        msk::plane_resp_header((const uint8_t*)pc.rbuf.data() + off, &status,
                               &length);
        const size_t body_len =
            status == 200 ? (size_t)length * 4 : (size_t)length;
        if (pc.rbuf.size() - off < msk::kPlaneRespHeaderLen + body_len) break;
        if (pc.pending.empty()) {
            plane_fail_all(i, "unsolicited plane frame");
            return;
        }
        PlanePending p = std::move(pc.pending.front());
        pc.pending.pop_front();
        complete_pending(p, status,
                         pc.rbuf.data() + off + msk::kPlaneRespHeaderLen,
                         body_len);
        off += msk::kPlaneRespHeaderLen + body_len;
    }
    if (off > 0) pc.rbuf.erase(0, off);
}

void Worker::plane_fail_all(size_t i, const char* why) {
    PlaneConn& pc = planes[i];
    if (pc.fd >= 0) {
        close(pc.fd);
        pc.fd = -1;
    }
    pc.wbuf.clear();
    pc.woff = 0;
    pc.rbuf.clear();
    pc.reconnect_at = mono_now() + 0.05;
    std::deque<PlanePending> pend;
    pend.swap(pc.pending);
    const std::string msg = std::string("compute plane error: ") + why;
    for (auto& p : pend) {
        if (p.zombie) continue;
        eng->plane_depth.fetch_sub(1, std::memory_order_relaxed);
        eng->stats.plane_errors.fetch_add(1, std::memory_order_relaxed);
        Conn* c = conn_at(p.slot, p.gen);
        if (c == nullptr) continue;
        reply_text(p.slot, 502, msg, {});
        finish_request(p.slot);
    }
}

void Worker::complete_pending(PlanePending& p, int status, const char* body,
                              size_t body_len) {
    const double now = mono_now();
    if (!p.zombie) {
        eng->plane_depth.fetch_sub(1, std::memory_order_relaxed);
    }
    if (!p.trace_id.empty()) {
        record_span("frontend.plane.ship", p.t_ship, now - p.t_ship,
                    p.trace_id);
    }
    Conn* c = conn_at(p.slot, p.gen);
    if (p.zombie || c == nullptr) return;  // late frame; FIFO already synced

    if (status == 200) {
        if (p.kind == Dispatch::Raw) {
            if (p.accepts_binary) {
                std::string out((size_t)msk::kWireHeaderLen + body_len, '\0');
                msk::wire_header((uint32_t)(body_len / 4), (uint8_t*)&out[0]);
                std::memcpy(&out[msk::kWireHeaderLen], body, body_len);
                reply(p.slot, 200, msk::kWireContentType, out, {}, true);
            } else {
                reply(p.slot, 200, "application/octet-stream",
                      std::string(body, body_len), {}, true);
            }
        } else if (p.kind == Dispatch::Compute) {
            int32_t v = 0;
            if (body_len >= 4) std::memcpy(&v, body, 4);
            char out[48];
            const int n = std::snprintf(out, sizeof(out),
                                        "{\"value\": %d}\n", v);
            reply(p.slot, 200, "application/json",
                  std::string(out, (size_t)n), {}, true);
        } else {
            std::string out = "{\"values\": [";
            msk::fmt_i32((const int32_t*)body, body_len / 4, ',', out);
            out += "]}\n";
            reply(p.slot, 200, "application/json", out, {}, true);
        }
    } else {
        // single-engine drain mapping: PlaneClient turns 599 into a 503
        // with the body preserved
        if (status == msk::kPlaneDraining) status = 503;
        plane_error_reply(p.slot, p, status, std::string(body, body_len));
    }
    if (!p.trace_id.empty()) {
        record_span("frontend.request", p.t_req_start, now - p.t_req_start,
                    p.trace_id);
    }
    finish_request(p.slot);
}

// The CPython tier's _plane_error: an EdgeReject-shaped JSON body renders
// as its message with the typed headers (and arms the shed cache on a
// 429 with Retry-After); anything else passes through verbatim.
void Worker::plane_error_reply(uint32_t slot, const PlanePending& p,
                               int status, const std::string& body) {
    JsonValue obj;
    std::string message;
    std::string tenant;
    bool has_tenant = false;
    std::string reason;
    double retry_after = -1.0;
    bool edge_shaped = false;
    if (msk::json_parse(body.data(), body.size(), obj) &&
        obj.kind == JsonValue::Object && obj.get("reason") != nullptr &&
        obj.get("reason")->kind == JsonValue::String) {
        edge_shaped = true;
        reason = obj.get_str("reason");
        message = obj.get_str("error");
        const JsonValue* ra = obj.get("retry_after");
        if (ra != nullptr && ra->kind == JsonValue::Number) {
            retry_after = ra->number;
        }
        const JsonValue* tv = obj.get("tenant");
        if (tv != nullptr && tv->kind == JsonValue::String) {
            tenant = tv->str;
            has_tenant = true;
        }
    }
    if (!edge_shaped) {
        reply_text(slot, status, body, {});
        return;
    }
    std::vector<std::pair<std::string, std::string>> extras;
    if (retry_after >= 0.0) {
        extras.emplace_back("Retry-After", retry_after_header(retry_after));
    }
    if (status == 401) {
        extras.emplace_back("WWW-Authenticate", kWwwAuth);
    }
    if (status == 429 && retry_after >= 0.0) {
        const double hold =
            retry_after < 0.25 ? 0.25 : (retry_after > 30.0 ? 30.0
                                                            : retry_after);
        std::string sk = p.shed_program;
        sk.push_back('\0');
        sk += p.shed_key;
        ShedEntry e;
        e.until = mono_now() + hold;
        e.message = message;
        e.tenant = tenant;
        e.has_tenant = has_tenant;
        e.reason = reason.empty() ? "rate" : reason;
        shed[sk] = std::move(e);
    }
    reply_text(slot, status, message, std::move(extras));
}

}  // namespace

// ---------------------------------------------------------------------------
// Worker: proxy lane to the CPython worker tier
// ---------------------------------------------------------------------------

namespace {

// headers the CPython tier forwards upstream / copies back downstream
const char* const kForwardHeaders[] = {"content-type", "x-misaka-program",
                                       "x-misaka-key", "authorization",
                                       "x-misaka-trace"};
const char* const kForwardNames[] = {"Content-Type", "X-Misaka-Program",
                                     "X-Misaka-Key", "Authorization",
                                     "X-Misaka-Trace"};
const char* const kCopyBack[] = {"x-misaka-trace", "server-timing",
                                 "deprecation", "link", "retry-after",
                                 "www-authenticate"};
const char* const kCopyBackNames[] = {"X-Misaka-Trace", "Server-Timing",
                                      "Deprecation", "Link", "Retry-After",
                                      "WWW-Authenticate"};

void Worker::start_proxy(uint32_t slot, const std::string& body) {
    Conn& c = *slots[slot];
    eng->stats.proxied.fetch_add(1, std::memory_order_relaxed);
    std::string req = c.req.method + " " + c.req.target + " HTTP/1.1\r\n";
    req += "Host: " + eng->cfg.proxy_host + "\r\n";
    for (size_t i = 0; i < sizeof(kForwardHeaders) / sizeof(char*); i++) {
        const std::string* v = c.req.get(kForwardHeaders[i]);
        if (v != nullptr && !v->empty()) {
            req += std::string(kForwardNames[i]) + ": " + *v + "\r\n";
        }
    }
    char clbuf[48];
    std::snprintf(clbuf, sizeof(clbuf), "Content-Length: %zu\r\n",
                  body.size());
    if (c.req.method == "POST") req += clbuf;
    req += "\r\n";
    req += body;
    c.up_req = std::move(req);
    c.up_woff = 0;
    c.up_rbuf.clear();
    c.up_body_need = -1;
    c.up_head_end = 0;
    c.up_attempts = 0;
    c.st = CState::Wait;
    update_events(slot);
    up_send(slot);
}

// A POST that proxies must carry its body: read it first with the same
// _read_body(required=False) limits the CPython tier applies, then hand
// the bytes to start_proxy.
void Worker::start_proxy_post(uint32_t slot) {
    Conn& c = *slots[slot];
    if (!c.req.has_content_length) {
        start_proxy(slot, std::string());
        return;
    }
    if (c.req.bad_content_length) {
        reply_text(slot, 400, "cannot parse Content-Length", {});
        c.close_after = true;
        return;
    }
    // beyond the engine cap the canonical 413 closes without reading;
    // answer it here so an unbounded body cannot park in our buffers
    const int64_t hard_cap =
        eng->cfg.max_body > eng->cfg.plane_body_limit
            ? eng->cfg.max_body
            : eng->cfg.plane_body_limit;
    if (c.req.content_length > hard_cap) {
        char msg[160];
        std::snprintf(msg, sizeof(msg),
                      "body of %lld bytes exceeds the %lld-byte cap "
                      "(MISAKA_MAX_BODY)",
                      (long long)c.req.content_length,
                      (long long)eng->cfg.max_body);
        reply_text(slot, 413, msg, {});
        c.close_after = true;
        return;
    }
    c.st = CState::Body;
    c.disp = Dispatch::Proxy;
    c.body_need = c.req.content_length;
}

void Worker::close_up(Conn& c) {
    if (c.upfd >= 0) {
        close(c.upfd);
        c.upfd = -1;
    }
    c.up_reused = false;
    c.up_connecting = false;
}

bool Worker::up_connect(uint32_t slot) {
    Conn& c = *slots[slot];
    const int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC,
                          0);
    if (fd < 0) return false;
    struct sockaddr_in addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)eng->cfg.proxy_port);
    if (inet_pton(AF_INET, eng->cfg.proxy_host.c_str(), &addr.sin_addr) != 1) {
        close(fd);
        return false;
    }
    if (connect(fd, (struct sockaddr*)&addr, sizeof(addr)) < 0 &&
        errno != EINPROGRESS) {
        close(fd);
        return false;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    c.upfd = fd;
    c.up_reused = false;
    c.up_connecting = true;
    ep_add(ep, fd, (K_UP << 48) | slot, EPOLLIN | EPOLLOUT);
    return true;
}

void Worker::up_send(uint32_t slot) {
    Conn& c = *slots[slot];
    c.up_attempts++;
    if (c.upfd < 0 && !up_connect(slot)) {
        up_fail(slot, strerror(errno));
        return;
    }
    if (c.up_connecting) return;  // EPOLLOUT completes the connect
    while (c.up_woff < c.up_req.size()) {
        const ssize_t n = send(c.upfd, c.up_req.data() + c.up_woff,
                               c.up_req.size() - c.up_woff, MSG_NOSIGNAL);
        if (n > 0) {
            c.up_woff += (size_t)n;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
        // a stale kept-alive upstream: retry once on a fresh socket
        if (c.up_reused && c.up_rbuf.empty() && c.up_attempts <= 2) {
            close_up(c);
            c.up_woff = 0;
            up_send(slot);
            return;
        }
        up_fail(slot, strerror(errno));
        return;
    }
}

void Worker::up_fail(uint32_t slot, const char* why) {
    Conn& c = *slots[slot];
    close_up(c);
    reply_text(slot, 502, std::string("engine unreachable: ") + why, {});
    finish_request(slot);
}

void Worker::on_up_io(uint32_t slot, uint32_t evmask) {
    if (slot >= slots.size() || !slots[slot]) return;
    Conn& c = *slots[slot];
    if (c.upfd < 0) return;
    if (c.up_connecting && (evmask & (EPOLLOUT | EPOLLHUP | EPOLLERR))) {
        int soerr = 0;
        socklen_t len = sizeof(soerr);
        getsockopt(c.upfd, SOL_SOCKET, SO_ERROR, &soerr, &len);
        if (soerr != 0) {
            close_up(c);
            if (c.up_attempts <= 1) {
                up_send(slot);  // one fresh retry
            } else {
                up_fail(slot, strerror(soerr));
            }
            return;
        }
        c.up_connecting = false;
        ep_mod(ep, c.upfd, (K_UP << 48) | slot, EPOLLIN);
        up_send(slot);
        if (!slots[slot] || c.upfd < 0) return;
    } else if (evmask & EPOLLOUT) {
        up_send(slot);
        if (!slots[slot] || c.upfd < 0) return;
    }
    if (!(evmask & (EPOLLIN | EPOLLHUP | EPOLLERR))) return;
    if (c.st != CState::Wait) return;
    char buf[65536];
    bool eof = false;
    while (true) {
        const ssize_t n = recv(c.upfd, buf, sizeof(buf), 0);
        if (n > 0) {
            c.up_rbuf.append(buf, (size_t)n);
            if (n < (ssize_t)sizeof(buf)) break;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        eof = true;
        break;
    }
    // parse the upstream head once it is complete
    if (c.up_body_need == -1) {
        const size_t pos = c.up_rbuf.find("\r\n\r\n");
        if (pos != std::string::npos) {
            c.up_head_end = pos + 4;
            int64_t clen = -1;
            bool up_close = false;
            size_t ls = c.up_rbuf.find("\r\n") + 2;
            while (ls < pos + 2) {
                size_t le = c.up_rbuf.find("\r\n", ls);
                if (le == std::string::npos || le > pos) le = pos;
                const size_t colon = c.up_rbuf.find(':', ls);
                if (colon != std::string::npos && colon < le) {
                    std::string name = c.up_rbuf.substr(ls, colon - ls);
                    for (char& ch : name) {
                        if (ch >= 'A' && ch <= 'Z') ch = (char)(ch + 32);
                    }
                    size_t vs = colon + 1;
                    while (vs < le && c.up_rbuf[vs] == ' ') vs++;
                    const std::string val = c.up_rbuf.substr(vs, le - vs);
                    if (name == "content-length") {
                        clen = atoll(val.c_str());
                    } else if (name == "connection") {
                        up_close = val.find("close") != std::string::npos;
                    }
                }
                ls = le + 2;
            }
            if (clen >= 0) {
                c.up_body_need = clen;
            } else {
                c.up_body_need = up_close ? -2 : 0;
            }
        }
    }
    if (c.up_body_need >= 0 &&
        c.up_rbuf.size() >= c.up_head_end + (size_t)c.up_body_need) {
        up_deliver(slot);
        return;
    }
    if (eof) {
        if (c.up_body_need == -2) {
            up_deliver(slot);
            return;
        }
        // died before/through the head: stale-retry once, else 502
        if (c.up_reused && c.up_body_need == -1 && c.up_attempts <= 2) {
            close_up(c);
            c.up_woff = 0;
            c.up_rbuf.clear();
            up_send(slot);
            return;
        }
        up_fail(slot, "connection closed before response");
    }
}

void Worker::up_deliver(uint32_t slot) {
    Conn& c = *slots[slot];
    // status
    int status = 502;
    if (c.up_rbuf.size() > 12 && c.up_rbuf.compare(0, 5, "HTTP/") == 0) {
        status = atoi(c.up_rbuf.c_str() + 9);
    }
    // headers we copy back + Content-Type
    std::vector<std::pair<std::string, std::string>> extras;
    std::string ctype;
    bool had_trace_hdr = false;
    bool up_close = false;
    size_t ls = c.up_rbuf.find("\r\n") + 2;
    const size_t pos = c.up_head_end - 4;
    while (ls < pos + 2) {
        size_t le = c.up_rbuf.find("\r\n", ls);
        if (le == std::string::npos || le > pos) le = pos;
        const size_t colon = c.up_rbuf.find(':', ls);
        if (colon != std::string::npos && colon < le) {
            std::string name = c.up_rbuf.substr(ls, colon - ls);
            for (char& ch : name) {
                if (ch >= 'A' && ch <= 'Z') ch = (char)(ch + 32);
            }
            size_t vs = colon + 1;
            while (vs < le && c.up_rbuf[vs] == ' ') vs++;
            const std::string val = c.up_rbuf.substr(vs, le - vs);
            if (name == "content-type") {
                ctype = val;
            } else if (name == "connection") {
                up_close = val.find("close") != std::string::npos;
            } else {
                for (size_t i = 0; i < sizeof(kCopyBack) / sizeof(char*);
                     i++) {
                    if (name == kCopyBack[i]) {
                        extras.emplace_back(kCopyBackNames[i], val);
                        if (i == 0) had_trace_hdr = true;
                    }
                }
            }
        }
        ls = le + 2;
    }
    std::string rbody =
        c.up_body_need >= 0
            ? c.up_rbuf.substr(c.up_head_end, (size_t)c.up_body_need)
            : c.up_rbuf.substr(c.up_head_end);
    if (up_close || c.up_body_need == -2) {
        close_up(c);
    } else {
        c.up_rbuf.clear();
        c.up_reused = true;
    }
    if (!c.trace_id.empty()) {
        record_span("frontend.proxy", c.t_start, mono_now() - c.t_start,
                    c.trace_id);
    }
    reply(slot, status, ctype.empty() ? nullptr : ctype.c_str(), rbody,
          std::move(extras), !had_trace_hdr);
    finish_request(slot);
}

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes surface for NativeFrontendSupervisor)
// ---------------------------------------------------------------------------

namespace {

bool parse_config(const char* json, Config& cfg, std::string& err) {
    JsonValue v;
    if (json == nullptr || !msk::json_parse(json, std::strlen(json), v) ||
        v.kind != JsonValue::Object) {
        err = "config must be a JSON object";
        return false;
    }
    cfg.port = (int)v.get_num("port", 0);
    cfg.threads = (int)v.get_num("threads", 2);
    cfg.max_conns = (int)v.get_num("max_conns", 1024);
    cfg.plane_conns = (int)v.get_num("plane_conns", 2);
    cfg.plane_depth_max = (int)v.get_num("plane_depth_max", 256);
    cfg.proxy_port = (int)v.get_num("proxy_port", 0);
    cfg.max_body = (int64_t)v.get_num("max_body", (double)(8 << 20));
    cfg.plane_body_limit =
        (int64_t)v.get_num("plane_body_limit", (double)(2 << 20));
    cfg.plane_timeout = v.get_num("plane_timeout_s", 30.0);
    cfg.plane_path = v.get_str("plane_path");
    cfg.proxy_host = v.get_str("proxy_host", "127.0.0.1");
    if (cfg.threads < 1) cfg.threads = 1;
    if (cfg.threads > 64) cfg.threads = 64;
    if (cfg.plane_conns < 1) cfg.plane_conns = 1;
    const std::string hs = v.get_str("handshake_hex");
    if (!hs.empty()) {
        if (hs.size() % 2 != 0) {
            err = "handshake_hex must be an even-length hex string";
            return false;
        }
        for (size_t i = 0; i < hs.size(); i += 2) {
            auto hexv = [](char ch) -> int {
                if (ch >= '0' && ch <= '9') return ch - '0';
                if (ch >= 'a' && ch <= 'f') return ch - 'a' + 10;
                if (ch >= 'A' && ch <= 'F') return ch - 'A' + 10;
                return -1;
            };
            const int hi = hexv(hs[i]), lo = hexv(hs[i + 1]);
            if (hi < 0 || lo < 0) {
                err = "handshake_hex must be hex";
                return false;
            }
            cfg.handshake.push_back((char)(hi * 16 + lo));
        }
    }
    if (cfg.plane_path.empty()) {
        err = "config requires plane_path";
        return false;
    }
    if (cfg.proxy_port <= 0) {
        err = "config requires proxy_port";
        return false;
    }
    return true;
}

std::shared_ptr<const PushState> parse_push(const char* json,
                                            std::string& err) {
    JsonValue v;
    if (json == nullptr || !msk::json_parse(json, std::strlen(json), v) ||
        v.kind != JsonValue::Object) {
        err = "push state must be a JSON object";
        return nullptr;
    }
    auto st = std::make_shared<PushState>();
    st->auth_armed = v.get_bool("auth_armed", false);
    const JsonValue* digests = v.get("digests");
    if (digests != nullptr && digests->kind == JsonValue::Object) {
        for (const auto& kv : digests->obj) {
            st->digests.insert(kv.first);
            if (kv.second.kind != JsonValue::Object) continue;
            const JsonValue* cap = kv.second.get("burst_cap");
            if (cap != nullptr && cap->kind == JsonValue::Number) {
                BurstQuota q;
                q.cap = cap->number;
                q.msg_mid = kv.second.get_str("burst_msg_mid");
                q.tenant = kv.second.get_str("tenant");
                st->bursts.emplace(kv.first, std::move(q));
            }
        }
    }
    st->missing_msg = v.get_str(
        "reject_missing",
        "API key required (X-Misaka-Key header or Authorization: "
        "Bearer <key>)");
    st->unknown_msg = v.get_str("reject_unknown", "unknown API key");
    const std::string hb = v.get_str("healthz_body");
    if (!hb.empty()) st->healthz_body = hb;
    const std::string hc = v.get_str("healthz_ctype");
    if (!hc.empty()) st->healthz_ctype = hc;
    const JsonValue* progs = v.get("programs");
    if (progs != nullptr && progs->kind == JsonValue::Array) {
        for (const auto& p : progs->arr) {
            if (p.kind == JsonValue::String) st->programs.insert(p.str);
        }
    }
    st->trace_enabled = v.get_bool("trace_enabled", false);
    st->trace_sample = v.get_num("trace_sample", 1.0);
    st->slo_armed = v.get_bool("slo_armed", false);
    st->capture_enabled = v.get_bool("capture_enabled", false);
    st->capture_sample = v.get_num("capture_sample", 1.0);
    return st;
}

}  // namespace

extern "C" {

const char* msk_edge_last_error() { return g_last_error.c_str(); }

int msk_edge_start(const char* config_json) {
    std::lock_guard<std::mutex> g(g_api_mu);
    if (g_engine != nullptr) {
        g_last_error = "native edge already running";
        return -1;
    }
    Config cfg;
    if (!parse_config(config_json, cfg, g_last_error)) return -1;

    std::vector<int> listeners;
    int actual_port = cfg.port;
    for (int i = 0; i < cfg.threads; i++) {
        const int fd = socket(AF_INET,
                              SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
        if (fd < 0) {
            g_last_error = std::string("socket: ") + strerror(errno);
            for (int lfd : listeners) close(lfd);
            return -1;
        }
        int one = 1;
        setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
        setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
        struct sockaddr_in addr;
        std::memset(&addr, 0, sizeof(addr));
        addr.sin_family = AF_INET;
        addr.sin_addr.s_addr = htonl(INADDR_ANY);
        addr.sin_port = htons((uint16_t)actual_port);
        if (bind(fd, (struct sockaddr*)&addr, sizeof(addr)) < 0 ||
            listen(fd, 1024) < 0) {
            g_last_error = std::string("bind/listen: ") + strerror(errno);
            close(fd);
            for (int lfd : listeners) close(lfd);
            return -1;
        }
        if (actual_port == 0) {
            struct sockaddr_in got;
            socklen_t len = sizeof(got);
            getsockname(fd, (struct sockaddr*)&got, &len);
            actual_port = (int)ntohs(got.sin_port);
        }
        listeners.push_back(fd);
    }

    Engine* eng = new Engine();
    eng->cfg = cfg;
    eng->listeners = listeners;
    eng->actual_port = actual_port;
    eng->workers.resize((size_t)cfg.threads);
    for (int i = 0; i < cfg.threads; i++) {
        Worker& w = eng->workers[(size_t)i];
        w.eng = eng;
        w.idx = i;
        w.listen_fd = listeners[(size_t)i];
        w.wake_fd = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
    }
    g_engine = eng;
    for (int i = 0; i < cfg.threads; i++) {
        eng->threads.emplace_back([eng, i] { eng->workers[(size_t)i].run(); });
    }
    return 0;
}

int msk_edge_port() {
    std::lock_guard<std::mutex> g(g_api_mu);
    return g_engine != nullptr ? g_engine->actual_port : -1;
}

int msk_edge_push_state(const char* json) {
    std::lock_guard<std::mutex> g(g_api_mu);
    if (g_engine == nullptr) {
        g_last_error = "native edge not running";
        return -1;
    }
    auto st = parse_push(json, g_last_error);
    if (st == nullptr) return -1;
    std::lock_guard<std::mutex> sg(g_engine->state_mu);
    g_engine->state = st;
    return 0;
}

int64_t msk_edge_stats(char* out, int64_t cap) {
    std::lock_guard<std::mutex> g(g_api_mu);
    if (g_engine == nullptr || out == nullptr) return -1;
    const Stats& s = g_engine->stats;
    char buf[640];
    const int n = std::snprintf(
        buf, sizeof(buf),
        "{\"port\": %d, \"threads\": %d, \"conns_open\": %llu, "
        "\"conns_total\": %llu, \"requests\": %llu, \"plane\": %llu, "
        "\"proxied\": %llu, \"plane_errors\": %llu, \"local_401\": %llu, "
        "\"local_413\": %llu, \"shed_hits\": %llu, \"overload\": %llu, "
        "\"depth\": %d}",
        g_engine->actual_port, g_engine->cfg.threads,
        (unsigned long long)s.conns_open.load(),
        (unsigned long long)s.conns_total.load(),
        (unsigned long long)s.requests.load(),
        (unsigned long long)s.plane_shipped.load(),
        (unsigned long long)s.proxied.load(),
        (unsigned long long)s.plane_errors.load(),
        (unsigned long long)s.local_401.load(),
        (unsigned long long)s.local_413.load(),
        (unsigned long long)s.shed_hits.load(),
        (unsigned long long)s.overload.load(),
        g_engine->plane_depth.load());
    if (n < 0 || n >= (int)cap) return -1;
    std::memcpy(out, buf, (size_t)n + 1);
    return n;
}

int64_t msk_edge_spans(char* out, int64_t cap) {
    std::lock_guard<std::mutex> g(g_api_mu);
    if (g_engine == nullptr || out == nullptr) return -1;
    std::deque<SpanRec> drained;
    {
        std::lock_guard<std::mutex> sg(g_engine->span_mu);
        drained.swap(g_engine->spans);
    }
    std::string js = "[";
    for (const auto& sp : drained) {
        if (js.size() > 1) js += ", ";
        js += "{\"name\": ";
        msk::json_append_str(js, sp.name);
        js += ", \"lane\": ";
        msk::json_append_str(js, sp.lane);
        js += ", \"trace\": ";
        msk::json_append_str(js, sp.trace);
        char nb[80];
        std::snprintf(nb, sizeof(nb), ", \"start\": %.9f, \"dur\": %.9f}",
                      sp.start, sp.dur);
        js += nb;
    }
    js += "]";
    if ((int64_t)js.size() + 1 > cap) return -1;
    std::memcpy(out, js.data(), js.size() + 1);
    return (int64_t)js.size();
}

int64_t msk_edge_captures(char* out, int64_t cap) {
    std::lock_guard<std::mutex> g(g_api_mu);
    if (g_engine == nullptr || out == nullptr) return -1;
    std::deque<CaptureRec> drained;
    uint64_t dropped = 0;
    {
        std::lock_guard<std::mutex> cg(g_engine->cap_mu);
        drained.swap(g_engine->caps);
        dropped = g_engine->caps_dropped;
        g_engine->caps_dropped = 0;
    }
    char db[48];
    std::snprintf(db, sizeof(db), "{\"dropped\": %llu, \"records\": [",
                  (unsigned long long)dropped);
    std::string js = db;
    bool first = true;
    for (const auto& r : drained) {
        if (!first) js += ", ";
        first = false;
        char tb[48];
        std::snprintf(tb, sizeof(tb), "{\"t\": %.6f, \"program\": ", r.t);
        js += tb;
        if (r.program.empty()) {
            js += "null";
        } else {
            msk::json_append_str(js, r.program);
        }
        js += ", \"trace\": ";
        if (r.trace.empty()) {
            js += "null";
        } else {
            msk::json_append_str(js, r.trace);
        }
        char sb[48];
        std::snprintf(sb, sizeof(sb), ", \"in\": %d, \"status\": %d",
                      r.trace.empty() ? 0 : 1, r.status);
        js += sb;
        js += ", \"reason\": ";
        msk::json_append_str(js, r.reason);
        js += "}";
    }
    js += "]}";
    if ((int64_t)js.size() + 1 > cap) return -1;
    std::memcpy(out, js.data(), js.size() + 1);
    return (int64_t)js.size();
}

void msk_edge_stop() {
    std::lock_guard<std::mutex> g(g_api_mu);
    if (g_engine == nullptr) return;
    g_engine->stopping.store(true);
    for (auto& w : g_engine->workers) {
        const uint64_t one = 1;
        ssize_t r = write(w.wake_fd, &one, 8);
        (void)r;
    }
    for (auto& t : g_engine->threads) t.join();
    // fd teardown strictly AFTER the join: a worker may still be
    // registering its listener with epoll (fast stop after start) or
    // draining the wake eventfd — closing under its feet is a race onto
    // a recyclable fd number.  The wake write above pops epoll_wait, so
    // the early listener close bought no shutdown latency anyway.
    for (const int fd : g_engine->listeners) close(fd);
    for (const auto& w : g_engine->workers) close(w.wake_fd);
    delete g_engine;
    g_engine = nullptr;
}

}  // extern "C"

// Identity tag for utils/nativelib.py's content-hash staleness check; the
// build injects -DMISAKA_SRC_HASH=<sha256[:16] of the three source units>.
#ifndef MISAKA_SRC_HASH
#define MISAKA_SRC_HASH "unbuilt"
#endif
extern "C" const char misaka_frontend_src_hash[] =
    "MISAKA-SRC-HASH:" MISAKA_SRC_HASH;
