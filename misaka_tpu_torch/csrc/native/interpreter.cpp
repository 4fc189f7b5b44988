// Native superstep interpreter: the whole-network tick discipline in C++.
//
// A third, independent implementation of the execution semantics (after the
// XLA/Pallas kernels and the Python oracle in tests/oracle.py), mirroring
// the reference's concurrent behavior under the deterministic superstep
// discipline documented in misaka_tpu/core/step.py:
//
//   phase A  lanes with a ready inbound-port source consume it into their
//            hold latch (port cleared) before any delivery
//   phase B  sends / stack ops / IN / OUT arbitrate by LOWEST LANE INDEX;
//            sends see post-consume occupancy plus this tick's deliveries;
//            at most one op per stack, one IN, one OUT per tick; stack and
//            ring feasibility use begin-of-tick tops/counters
//   commit   a lane commits iff source ready and destination granted;
//            effects read begin-of-tick registers; PC wraps modulo program
//            length (program.go:429), JRO clamps (program.go:354)
//
// Uses: differential testing against the kernels (tests/test_native_interp.py)
// and a zero-JAX host executor for tiny control-plane runs.  C ABI for
// ctypes (misaka_tpu/core/cinterp.py).  Build: make native.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

#if defined(__linux__)
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif

// Per-program specialization (core/specialize.py): the build injects
// -DMISAKA_SPEC_HEADER pointing at a generated header that bakes ONE
// network's tables (code/prog_len) and dimensions as constexpr data in
// namespace spec, and defines MISAKA_SPEC.  The same source then compiles
// into a .so whose group tick paths constant-fold every dimension and read
// the program straight from .rodata; misaka_pool_create falls back to the
// generic paths when the runtime tables don't match the baked ones, so a
// stale cache entry degrades, never corrupts.
#ifdef MISAKA_SPEC_HEADER
#include MISAKA_SPEC_HEADER
#endif

namespace {

enum Op {
  OP_NOP = 0, OP_SWP = 1, OP_SAV = 2, OP_NEG = 3,
  OP_MOV_LOCAL = 4, OP_MOV_NET = 5, OP_ADD = 6, OP_SUB = 7,
  OP_JMP = 8, OP_JEZ = 9, OP_JNZ = 10, OP_JGZ = 11, OP_JLZ = 12,
  OP_JRO = 13, OP_PUSH = 14, OP_POP = 15, OP_IN = 16, OP_OUT = 17,
};
enum Src { SRC_IMM = 0, SRC_ACC = 1, SRC_NIL = 2, SRC_R0 = 3 };
enum Dst { DST_ACC = 0, DST_NIL = 1 };
enum Field { F_OP = 0, F_SRC, F_IMM, F_DST, F_TGT, F_PORT, F_JMP, NFIELDS };

constexpr int kPorts = 4;

inline int32_t i32(int64_t v) { return (int32_t)(uint32_t)(uint64_t)v; }

// --- flat futex/spin dispenser primitives (r17) ----------------------------
//
// The serving pool's per-call wake used to be a condition-variable
// broadcast plus a mutexed done barrier: ~180us/call of futex churn and
// lock convoys at 24 threads (BENCH_HISTORY r16).  The pool below runs the
// same one-caller/many-workers discipline on flat atomics instead: the
// caller publishes a job by bumping `job_seq` (workers spin briefly — the
// inter-call gap under load is shorter than a context switch — then park
// on a futex), the existing atomic unit dispenser hands out work, and the
// last worker to finish stores `done_seq` and wakes the caller, which
// spins-then-parks symmetrically.  Happens-before rides the atomics (the
// seq_cst bump of job_seq publishes the job arrays; the acq_rel countdown
// of active_workers chains every worker's writes into the release store
// of done_seq), so no mutex is needed anywhere on the round trip.  On
// non-Linux the futex calls degrade to yield — every wait loop re-checks
// its predicate.

inline void cpu_pause() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#else
  std::this_thread::yield();
#endif
}

inline void futex_wait_u32(std::atomic<uint32_t>* addr, uint32_t expect) {
#if defined(__linux__)
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT_PRIVATE,
          expect, nullptr, nullptr, 0);
#else
  (void)addr;
  (void)expect;
  std::this_thread::yield();
#endif
}

inline void futex_wake_u32(std::atomic<uint32_t>* addr, int n) {
#if defined(__linux__)
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE_PRIVATE,
          n, nullptr, nullptr, 0);
#else
  (void)addr;
  (void)n;
#endif
}

inline bool reads_src(int op) {
  switch (op) {
    case OP_MOV_LOCAL: case OP_MOV_NET: case OP_ADD: case OP_SUB:
    case OP_JRO: case OP_PUSH: case OP_OUT:
      return true;
    default:
      return false;
  }
}

struct Interp {
  int n_lanes, max_len, num_stacks, stack_cap, in_cap, out_cap;
  std::vector<int32_t> code;      // [n_lanes][max_len][NFIELDS]
  std::vector<int32_t> prog_len;  // [n_lanes]

  // acc/bak are the reference's 64-bit Go ints (program.go:27-28); only
  // the wire truncates to int32 (messenger.proto:34-41).  Arithmetic wraps
  // at 64 bits via unsigned ops (signed overflow is UB in C++; Go wraps).
  std::vector<int64_t> acc, bak;
  std::vector<int32_t> pc, hold_val, retired;
  std::vector<uint8_t> holding;
  std::vector<int32_t> port_val;   // [n_lanes][kPorts]
  std::vector<uint8_t> port_full;  // [n_lanes][kPorts]
  std::vector<std::vector<int32_t>> stacks;
  std::vector<int32_t> in_buf, out_buf;
  int32_t in_rd = 0, in_wr = 0, out_rd = 0, out_wr = 0, tick_count = 0;

  // Per-tick scratch, sized once at create and REUSED across ticks: the
  // multi-threaded serving pool below makes tick() the host throughput hot
  // path, and ~10 heap allocations per tick measurably cap it.  assign()
  // on an already-right-sized vector never reallocates.
  struct Delivery { int tgt, port; int32_t val; };
  std::vector<int64_t> s_src_val, s_old_acc, s_old_bak;
  std::vector<uint8_t> s_src_ok, s_granted, s_stack_taken, s_pushed;
  std::vector<int32_t> s_begin_tops, s_pop_val;
  std::vector<Delivery> s_deliveries;
  std::vector<std::pair<int, int32_t>> s_stack_pushes;

  const int32_t* ins(int lane) const {
    return &code[(size_t)(lane * max_len + pc[lane]) * NFIELDS];
  }

  // Returns whether the tick made ANY progress (a port consume or an
  // instruction commit).  The network is deterministic, so a zero-progress
  // tick proves every later tick is an identity step too — interp_run uses
  // that to stop early on a quiescent/blocked network (the serving chunk is
  // sized for throughput, 2048 ticks, while a typical request drains in a
  // few hundred; the tail used to be pure waste on the partial-fill path).
  bool tick() {
    const int n = n_lanes;
    bool progressed = false;

    // phase A: consume ready port sources into the hold latch
    for (int l = 0; l < n; ++l) {
      const int32_t* f = ins(l);
      if (reads_src(f[F_OP]) && f[F_SRC] >= SRC_R0) {
        int p = f[F_SRC] - SRC_R0;
        if (!holding[l] && port_full[l * kPorts + p]) {
          hold_val[l] = port_val[l * kPorts + p];
          holding[l] = 1;
          port_full[l * kPorts + p] = 0;
          progressed = true;
        }
      }
    }

    // source resolution (64-bit: an ACC source carries full width; the
    // wire sites below truncate with i32())
    std::vector<int64_t>& src_val = s_src_val;
    std::vector<uint8_t>& src_ok = s_src_ok;
    src_val.assign(n, 0);
    src_ok.assign(n, 1);
    for (int l = 0; l < n; ++l) {
      const int32_t* f = ins(l);
      if (!reads_src(f[F_OP])) continue;
      switch (f[F_SRC]) {
        case SRC_IMM: src_val[l] = f[F_IMM]; break;
        case SRC_ACC: src_val[l] = acc[l]; break;
        case SRC_NIL: src_val[l] = 0; break;
        default:
          src_val[l] = hold_val[l];
          src_ok[l] = holding[l];
      }
    }

    // arbitration: lowest lane index wins each resource
    std::vector<uint8_t>& granted = s_granted;
    std::vector<int32_t>& begin_tops = s_begin_tops;
    std::vector<uint8_t>& stack_taken = s_stack_taken;
    std::vector<Delivery>& deliveries = s_deliveries;
    std::vector<std::pair<int, int32_t>>& stack_pushes = s_stack_pushes;
    std::vector<int32_t>& pop_val = s_pop_val;
    granted.assign(n, 0);
    begin_tops.resize(num_stacks);
    for (int s = 0; s < num_stacks; ++s) begin_tops[s] = (int32_t)stacks[s].size();
    stack_taken.assign(num_stacks, 0);
    deliveries.clear();
    stack_pushes.clear();  // (stack, value)
    pop_val.assign(n, 0);
    bool in_taken = false, out_taken = false;
    const bool in_avail = in_wr - in_rd > 0;
    const bool out_free = out_wr - out_rd < out_cap;
    int in_winner = -1;
    int32_t out_value = 0;

    for (int l = 0; l < n; ++l) {
      const int32_t* f = ins(l);
      switch (f[F_OP]) {
        case OP_MOV_NET: {
          if (!src_ok[l]) break;
          int tgt = f[F_TGT], port = f[F_PORT];
          bool occupied = port_full[tgt * kPorts + port];
          for (const auto& d : deliveries)
            occupied |= (d.tgt == tgt && d.port == port);
          if (!occupied) {
            deliveries.push_back({tgt, port, i32(src_val[l])});  // wire: sint32
            granted[l] = 1;
          }
          break;
        }
        case OP_PUSH: {
          if (!src_ok[l]) break;
          int s = f[F_TGT];
          if (!stack_taken[s] && begin_tops[s] < stack_cap) {
            stack_taken[s] = 1;
            stack_pushes.push_back({s, i32(src_val[l])});  // wire: sint32
            granted[l] = 1;
          }
          break;
        }
        case OP_POP: {
          int s = f[F_TGT];
          if (!stack_taken[s] && begin_tops[s] > 0) {
            stack_taken[s] = 1;
            pop_val[l] = stacks[s].back();
            granted[l] = 1;
          }
          break;
        }
        case OP_IN:
          if (in_avail && !in_taken) {
            in_taken = true;
            in_winner = l;
            granted[l] = 1;
          }
          break;
        case OP_OUT:
          if (src_ok[l] && out_free && !out_taken) {
            out_taken = true;
            out_value = i32(src_val[l]);
            granted[l] = 1;
          }
          break;
        default:
          break;
      }
    }

    // commit + register/pc effects (reading begin-of-tick acc/bak)
    std::vector<int64_t>& old_acc = s_old_acc;
    std::vector<int64_t>& old_bak = s_old_bak;
    old_acc = acc;
    old_bak = bak;
    for (int l = 0; l < n; ++l) {
      const int32_t* f = ins(l);
      int op = f[F_OP];
      bool needs_grant = op == OP_MOV_NET || op == OP_PUSH || op == OP_POP ||
                         op == OP_IN || op == OP_OUT;
      bool commit = needs_grant ? granted[l] : src_ok[l];
      if (!commit) continue;
      progressed = true;
      int32_t ln = prog_len[l];
      switch (op) {
        case OP_MOV_LOCAL:
          if (f[F_DST] == DST_ACC) acc[l] = src_val[l];
          break;
        case OP_ADD:
          acc[l] = (int64_t)((uint64_t)old_acc[l] + (uint64_t)src_val[l]);
          break;
        case OP_SUB:
          acc[l] = (int64_t)((uint64_t)old_acc[l] - (uint64_t)src_val[l]);
          break;
        case OP_NEG: acc[l] = (int64_t)(0 - (uint64_t)old_acc[l]); break;
        case OP_SWP: acc[l] = old_bak[l]; bak[l] = old_acc[l]; break;
        case OP_SAV: bak[l] = old_acc[l]; break;
        case OP_POP:
          if (f[F_DST] == DST_ACC) acc[l] = pop_val[l];
          break;
        case OP_IN:
          if (f[F_DST] == DST_ACC) acc[l] = in_buf[in_rd % in_cap];
          break;
        default: break;
      }
      bool taken = op == OP_JMP || (op == OP_JEZ && old_acc[l] == 0) ||
                   (op == OP_JNZ && old_acc[l] != 0) ||
                   (op == OP_JGZ && old_acc[l] > 0) ||
                   (op == OP_JLZ && old_acc[l] < 0);
      if (taken) {
        pc[l] = f[F_JMP];
      } else if (op == OP_JRO) {
        // 64-bit offset: saturate by sign when it exceeds int32 (signed
        // pc+offset could overflow int64 — UB; mirrors regs64.jro_target)
        int64_t v = src_val[l];
        int64_t t = (v >= INT32_MIN && v <= INT32_MAX)
                        ? (int64_t)pc[l] + v
                        : (v < 0 ? 0 : (int64_t)ln - 1);
        pc[l] = (int32_t)(t < 0 ? 0 : (t > ln - 1 ? ln - 1 : t));
      } else {
        pc[l] = (pc[l] + 1) % ln;
      }
      holding[l] = 0;
      // wrap-safe: signed int32 overflow is UB, and soak runs can pass 2^31
      // commits; the JAX kernels wrap deterministically, match them.
      retired[l] = i32((int64_t)retired[l] + 1);
    }

    // apply resource effects
    for (const auto& d : deliveries) {
      port_full[d.tgt * kPorts + d.port] = 1;
      port_val[d.tgt * kPorts + d.port] = d.val;
    }
    std::vector<uint8_t>& pushed = s_pushed;
    pushed.assign(num_stacks, 0);
    for (const auto& p : stack_pushes) {
      stacks[p.first].push_back(p.second);
      pushed[p.first] = 1;
    }
    for (int s = 0; s < num_stacks; ++s)
      if (stack_taken[s] && !pushed[s]) stacks[s].pop_back();
    if (in_winner >= 0) in_rd += 1;
    if (out_taken) {
      out_buf[out_wr % out_cap] = out_value;
      out_wr += 1;
    }
    tick_count = i32((int64_t)tick_count + 1);  // wrap-safe, like retired
    return progressed;
  }
};

// --- internal bodies of the C ABI, shared with the serving pool below ------

Interp* create_interp(const int32_t* code, const int32_t* prog_len,
                      int n_lanes, int max_len, int num_stacks, int stack_cap,
                      int in_cap, int out_cap) {
  if (n_lanes <= 0 || max_len <= 0 || stack_cap <= 0 || in_cap <= 0 ||
      out_cap <= 0)
    return nullptr;
  auto* it = new Interp();
  it->n_lanes = n_lanes;
  it->max_len = max_len;
  it->num_stacks = num_stacks < 1 ? 1 : num_stacks;
  it->stack_cap = stack_cap;
  it->in_cap = in_cap;
  it->out_cap = out_cap;
  it->code.assign(code, code + (size_t)n_lanes * max_len * NFIELDS);
  it->prog_len.assign(prog_len, prog_len + n_lanes);
  for (int l = 0; l < n_lanes; ++l) {
    if (it->prog_len[l] <= 0 || it->prog_len[l] > max_len) {
      delete it;
      return nullptr;
    }
  }
  // Validate every reachable instruction word: the engine indexes ports,
  // stacks, and jump targets straight from these fields, so a malformed
  // table must be rejected here, not corrupt memory later.
  for (int l = 0; l < n_lanes; ++l) {
    for (int i = 0; i < it->prog_len[l]; ++i) {
      const int32_t* f = &it->code[(size_t)(l * max_len + i) * NFIELDS];
      int op = f[F_OP];
      bool ok = op >= OP_NOP && op <= OP_OUT;
      if (ok && reads_src(op))
        ok = f[F_SRC] >= SRC_IMM && f[F_SRC] < SRC_R0 + kPorts;
      if (ok && op == OP_MOV_NET)
        ok = f[F_TGT] >= 0 && f[F_TGT] < n_lanes && f[F_PORT] >= 0 &&
             f[F_PORT] < kPorts;
      if (ok && (op == OP_PUSH || op == OP_POP))
        ok = f[F_TGT] >= 0 && f[F_TGT] < it->num_stacks;
      if (ok && op >= OP_JMP && op <= OP_JLZ)
        ok = f[F_JMP] >= 0 && f[F_JMP] < it->prog_len[l];
      if (ok && (op == OP_MOV_LOCAL || op == OP_POP || op == OP_IN))
        ok = f[F_DST] == DST_ACC || f[F_DST] == DST_NIL;
      if (!ok) {
        delete it;
        return nullptr;
      }
    }
  }
  it->acc.assign(n_lanes, 0);
  it->bak.assign(n_lanes, 0);
  it->pc.assign(n_lanes, 0);
  it->hold_val.assign(n_lanes, 0);
  it->retired.assign(n_lanes, 0);
  it->holding.assign(n_lanes, 0);
  it->port_val.assign((size_t)n_lanes * kPorts, 0);
  it->port_full.assign((size_t)n_lanes * kPorts, 0);
  it->stacks.resize(it->num_stacks);
  it->in_buf.assign(in_cap, 0);
  it->out_buf.assign(out_cap, 0);
  return it;
}

int interp_feed(Interp* it, const int32_t* values, int count) {
  int fed = 0;
  for (int i = 0; i < count; ++i) {
    if (it->in_wr - it->in_rd >= it->in_cap) break;
    it->in_buf[it->in_wr % it->in_cap] = values[i];
    it->in_wr += 1;
    fed += 1;
  }
  return fed;
}

void interp_run(Interp* it, int ticks) {
  for (int i = 0; i < ticks; ++i) {
    if (!it->tick()) {
      // Quiescent: the remaining ticks are identity steps except the tick
      // counter — add them in one wrap-safe step so the exported state
      // stays BIT-IDENTICAL to the fixed-length XLA chunk (the
      // differential suites pin native vs jitted state equality).
      it->tick_count = i32((int64_t)it->tick_count + (ticks - 1 - i));
      break;
    }
  }
  // Rebase ring counters below the int32 wrap at the chunk boundary, exactly
  // like the device engines (core/state.py rebase_rings): a multiple of the
  // ring capacity preserves slot indices and occupancy.
  const int32_t kThreshold = 1 << 30;
  if (it->in_rd > kThreshold) {
    int32_t base = (it->in_rd / it->in_cap) * it->in_cap;
    it->in_rd -= base;
    it->in_wr -= base;
  }
  if (it->out_rd > kThreshold) {
    int32_t base = (it->out_rd / it->out_cap) * it->out_cap;
    it->out_rd -= base;
    it->out_wr -= base;
  }
}

int write_state(Interp* it, const int32_t* acc, const int32_t* bak,
                const int32_t* pc, const int32_t* port_val,
                const uint8_t* port_full, const int32_t* hold_val,
                const uint8_t* holding, const int32_t* stack_mem,
                const int32_t* stack_top, const int32_t* in_buf,
                const int32_t* out_buf, const int32_t* counters /*[5]*/,
                const int32_t* retired, const int32_t* acc_hi,
                const int32_t* bak_hi) {
  const int n = it->n_lanes;
  for (int l = 0; l < n; ++l)
    if (pc[l] < 0 || pc[l] >= it->prog_len[l]) return -1;
  for (int s = 0; s < it->num_stacks; ++s)
    if (stack_top[s] < 0 || stack_top[s] > it->stack_cap) return -1;
  const int32_t in_rd = counters[0], in_wr = counters[1];
  const int32_t out_rd = counters[2], out_wr = counters[3];
  if (in_rd < 0 || in_wr < in_rd || in_wr - in_rd > it->in_cap ||
      out_rd < 0 || out_wr < out_rd || out_wr - out_rd > it->out_cap)
    return -1;
  for (int l = 0; l < n; ++l) {
    it->acc[l] = (int64_t)(((uint64_t)(uint32_t)acc_hi[l] << 32) |
                           (uint32_t)acc[l]);
    it->bak[l] = (int64_t)(((uint64_t)(uint32_t)bak_hi[l] << 32) |
                           (uint32_t)bak[l]);
  }
  std::memcpy(it->pc.data(), pc, n * 4);
  std::memcpy(it->port_val.data(), port_val, (size_t)n * kPorts * 4);
  std::memcpy(it->port_full.data(), port_full, (size_t)n * kPorts);
  for (size_t i = 0; i < it->port_full.size(); ++i)
    it->port_full[i] = it->port_full[i] ? 1 : 0;
  std::memcpy(it->hold_val.data(), hold_val, n * 4);
  for (int l = 0; l < n; ++l) it->holding[l] = holding[l] ? 1 : 0;
  for (int s = 0; s < it->num_stacks; ++s) {
    it->stacks[s].assign(stack_mem + (size_t)s * it->stack_cap,
                         stack_mem + (size_t)s * it->stack_cap + stack_top[s]);
  }
  std::memcpy(it->in_buf.data(), in_buf, (size_t)it->in_cap * 4);
  std::memcpy(it->out_buf.data(), out_buf, (size_t)it->out_cap * 4);
  it->in_rd = in_rd;
  it->in_wr = in_wr;
  it->out_rd = out_rd;
  it->out_wr = out_wr;
  it->tick_count = counters[4];
  std::memcpy(it->retired.data(), retired, n * 4);
  return 0;
}

void read_state(Interp* it, int32_t* acc, int32_t* bak, int32_t* pc,
                int32_t* port_val, uint8_t* port_full, int32_t* hold_val,
                uint8_t* holding, int32_t* stack_mem, int32_t* stack_top,
                int32_t* out_buf, int32_t* counters /*[5]*/, int32_t* retired,
                int32_t* acc_hi, int32_t* bak_hi) {
  int n = it->n_lanes;
  for (int l = 0; l < n; ++l) {
    acc[l] = i32(it->acc[l]);
    acc_hi[l] = (int32_t)(it->acc[l] >> 32);
    bak[l] = i32(it->bak[l]);
    bak_hi[l] = (int32_t)(it->bak[l] >> 32);
  }
  std::memcpy(pc, it->pc.data(), n * 4);
  std::memcpy(port_val, it->port_val.data(), (size_t)n * kPorts * 4);
  std::memcpy(port_full, it->port_full.data(), (size_t)n * kPorts);
  std::memcpy(hold_val, it->hold_val.data(), n * 4);
  std::memcpy(holding, it->holding.data(), n);
  std::memcpy(retired, it->retired.data(), n * 4);
  for (int s = 0; s < it->num_stacks; ++s) {
    stack_top[s] = (int32_t)it->stacks[s].size();
    for (int c = 0; c < it->stack_cap; ++c)
      stack_mem[s * it->stack_cap + c] =
          c < (int)it->stacks[s].size() ? it->stacks[s][c] : 0;
  }
  std::memcpy(out_buf, it->out_buf.data(), (size_t)it->out_cap * 4);
  counters[0] = it->in_rd;
  counters[1] = it->in_wr;
  counters[2] = it->out_rd;
  counters[3] = it->out_wr;
  counters[4] = it->tick_count;
}

// --- SIMD struct-of-arrays group engine ------------------------------------
//
// The throughput rewrite of the tick loop (ROADMAP "raw speed"): one worker
// thread steps kGroupW replicas at once, with every per-lane scalar of the
// Interp above widened into a contiguous [*, kGroupW] plane — struct of
// arrays across REPLICAS, the batch axis, not across a network's lanes.
// The superstep discipline makes replicas fully independent within a tick
// (instances never share ports, stacks, or rings), so the replica axis is
// embarrassingly data-parallel: the per-lane loops run their replica
// dimension innermost over contiguous memory, the clean ones annotated
// `#pragma omp simd` (compiled with -fopenmp-simd — no OpenMP runtime),
// and the instruction fetch is hoisted out of the lane loops into per-field
// SoA planes once per tick.
//
// The whole serve body is instantiated from ONE template into two
// functions: inside an `__attribute__((target("avx2")))` wrapper (AVX2
// codegen, 8 int32 per vector = kGroupW) and with default codegen (the
// scalar fallback).  Runtime CPU detection (__builtin_cpu_supports) picks
// the variant at pool creation; both execute the same statements in the
// same order on the same integer types, so outputs are bit-identical to
// each other AND to the scalar Interp, which remains the oracle and the
// MISAKA_SIMD=0 kill-switch path (the differential suites pin all three).
//
//   MISAKA_SIMD=0|off     pool runs the shipped scalar per-replica path
//   MISAKA_SIMD=generic   group path, default codegen (the no-AVX2 ladder
//                         rung, forceable for tests on any box)
//   MISAKA_SIMD=1|auto    group path, AVX2 when the CPU has it (default)

constexpr int kGroupW = 8;  // replicas per group: one AVX2 int32 vector

enum SimdMode { SIMD_OFF = 0, SIMD_GENERIC = 1, SIMD_AVX2 = 2 };

SimdMode simd_mode_from_env() {
  const char* e = std::getenv("MISAKA_SIMD");
  if (e != nullptr && (std::strcmp(e, "0") == 0 || std::strcmp(e, "off") == 0))
    return SIMD_OFF;
  const bool force_generic = e != nullptr && std::strcmp(e, "generic") == 0;
#if defined(__x86_64__) || defined(__i386__)
  if (!force_generic && __builtin_cpu_supports("avx2")) return SIMD_AVX2;
#else
  (void)force_generic;
#endif
  return SIMD_GENERIC;
}

// --- copy-and-patch JIT tick tier (raw speed phase 4) ----------------------
// core/jit.py compiles native/stencils.cpp ONCE (content-keyed in the spec
// cache), parses the relocation table out of the .o, and splices + patches
// per-(lane, pc) machine-code fragments into an executable buffer.  The
// pool is handed two flat [n_lanes * max_len] tables of fragment entry
// points (pass 1 = fetch/phase-A/source-resolution, pass 2 =
// arbitration/commit) via misaka_pool_jit_arm; group ticks then dispatch
// through baked code instead of the switch-threaded / generic template
// tick.  MisakaJitCtx is the fragment ABI: raw pointers into one Group's
// planes plus the in-flight tick's stack scratch.  The struct is
// DUPLICATED in native/stencils.cpp on purpose (a shared header would
// dodge the src-hash staleness keying, which only covers this file);
// MISAKA_JIT_ABI is checked at arm time so a drifted pair falls back one
// rung instead of corrupting.
#define MISAKA_JIT_ABI 1

struct MisakaJitCtx {
  int64_t* acc;            // [n_lanes * W]
  int64_t* bak;            // [n_lanes * W]
  int32_t* pc;             // [n_lanes * W]
  int32_t* hold_val;       // [n_lanes * W]
  int32_t* retired;        // [n_lanes * W]
  uint8_t* holding;        // [n_lanes * W]
  int32_t* port_val;       // [n_lanes * kPorts * W]
  uint8_t* port_full;      // [n_lanes * kPorts * W]
  int32_t* stack_mem;      // [W][num_stacks][stack_cap]
  int32_t* in_buf;         // [W][in_cap]
  int32_t* in_rd;          // [W]
  int64_t* s_src_val;      // [n_lanes * W]
  uint8_t* s_src_ok;       // [n_lanes * W]
  uint8_t* s_deliv_full;   // [n_lanes * kPorts * W]
  int32_t* s_deliv_val;    // [n_lanes * kPorts * W]
  int32_t* s_begin_top;    // [num_stacks * W]
  uint8_t* s_stack_taken;  // [num_stacks * W]
  uint8_t* s_pushed;       // [num_stacks * W]
  int32_t* s_push_val;     // [num_stacks * W]
  uint8_t* moved;          // [W]
  uint8_t* io_in_avail;    // [W]
  uint8_t* io_out_free;    // [W]
  uint8_t* io_in_taken;    // [W]
  uint8_t* io_out_taken;   // [W]
  int32_t* io_in_win;      // [W]
  int32_t* io_out_value;   // [W]
};

using MisakaJitFn = void (*)(MisakaJitCtx*, uint64_t);

// One pool serve/idle job (batch-major state arrays, see misaka_pool_serve).
struct Job {
  int32_t *acc = nullptr, *bak = nullptr, *pc = nullptr, *port_val = nullptr;
  uint8_t* port_full = nullptr;
  int32_t* hold_val = nullptr;
  uint8_t* holding = nullptr;
  int32_t *stack_mem = nullptr, *stack_top = nullptr, *in_buf = nullptr,
          *out_buf = nullptr, *counters = nullptr, *retired = nullptr;
  int32_t *acc_hi = nullptr, *bak_hi = nullptr;
  const int32_t* feed_vals = nullptr;    // [B, in_cap], null when idle
  const int32_t* feed_counts = nullptr;  // [B], null when idle
  int ticks = 0;
  bool feeding = false;
  int32_t* packed = nullptr;  // [B, 4+out_cap] serve / [B, 4] idle
  // Partial-fill fast path: when non-null, ONLY these replica indices
  // (strictly increasing, validated at the entry point) are imported,
  // fed, run, and exported — an underfilled serve pass pays for the
  // replicas actually working, not the whole batch.  The Python caller
  // prefills skipped replicas' packed rows from their current counters
  // (on the RESIDENT path the C++ side fills every row itself).
  const int32_t* active = nullptr;
  int n_active = 0;
  // Resident-path extras: progress[rep] = 1 when the replica retired an
  // instruction during the call — the device loop's hot-set signal, which
  // the stateless path derives from the exported `retired` plane.
  uint8_t* progress = nullptr;
  // Pack-row elision (resident path): nonzero when the caller is reusing
  // the SAME packed buffer as the previous call of this kind, so rows of
  // quiescent replicas that are already current in it may be skipped.
  int reuse = 0;
};

// SoA scratch for one group of kGroupW replicas.  Pure scratch: state lives
// in the caller's batch-major arrays between calls (the pool is stateless),
// so ONE Group per worker thread serves every group unit that thread picks
// up.  Planes are indexed [x * kGroupW + r].
struct Group {
  int n_lanes, max_len, num_stacks, stack_cap, in_cap, out_cap;
  const int32_t* code;      // borrowed from the owning pool (shared program)
  const int32_t* prog_len;

  std::vector<int64_t> acc, bak;               // [n][W]
  std::vector<int32_t> pc, hold_val, retired;  // [n][W]
  std::vector<uint8_t> holding;                // [n][W]
  std::vector<int32_t> port_val;               // [n][kPorts][W]
  std::vector<uint8_t> port_full;              // [n][kPorts][W]
  // Rings and stack memory stay REPLICA-major ([W][...], the job-array
  // layout): inside a tick they are only ever touched scalar per replica
  // (per-replica ring cursors / stack tops index them), so the SoA
  // transpose would buy nothing — while replica-major makes their
  // import/export a straight memcpy, which dominates the per-call floor
  // at serving batch sizes.
  std::vector<int32_t> stack_mem;              // [W][S][cap]
  std::vector<int32_t> stack_top;              // [S][W]
  std::vector<int32_t> in_buf;                 // [W][in_cap]
  std::vector<int32_t> out_buf;                // [W][out_cap]
  int32_t in_rd[kGroupW], in_wr[kGroupW], out_rd[kGroupW], out_wr[kGroupW];
  int32_t tick_count[kGroupW];

  // Spliced JIT fragment tables ([n_lanes][max_len] per pass), owned by
  // the pool; null until misaka_pool_jit_arm.  When set, group_tick_for
  // dispatches group_tick_jit instead of the template/switch tick.
  const MisakaJitFn* jit1 = nullptr;
  const MisakaJitFn* jit2 = nullptr;

  // per-tick scratch: cached instruction pointers + decoded op plane
  // (fetch hoists the pc chase out of the phase loops; the remaining
  // fields read through f_ptr, L1-hot) plus the widened arbitration
  // state of Interp::tick
  std::vector<const int32_t*> f_ptr;                     // [n][W]
  std::vector<int32_t> s_op;                             // [n][W]
  std::vector<int64_t> s_src_val;                        // [n][W]
  std::vector<uint8_t> s_src_ok;                         // [n][W]
  std::vector<uint8_t> s_deliv_full;                     // [n][kPorts][W]
  std::vector<int32_t> s_deliv_val;                      // [n][kPorts][W]
  std::vector<int32_t> s_begin_top;                      // [S][W]
  std::vector<uint8_t> s_stack_taken, s_pushed;          // [S][W]
  std::vector<int32_t> s_push_val;                       // [S][W]

  Group(const int32_t* code_, const int32_t* prog_len_, int n_lanes_,
        int max_len_, int num_stacks_, int stack_cap_, int in_cap_,
        int out_cap_)
      : n_lanes(n_lanes_), max_len(max_len_), num_stacks(num_stacks_),
        stack_cap(stack_cap_), in_cap(in_cap_), out_cap(out_cap_),
        code(code_), prog_len(prog_len_) {
    const size_t nW = (size_t)n_lanes * kGroupW;
    const size_t pW = (size_t)n_lanes * kPorts * kGroupW;
    const size_t sW = (size_t)num_stacks * kGroupW;
    acc.assign(nW, 0); bak.assign(nW, 0);
    pc.assign(nW, 0); hold_val.assign(nW, 0); retired.assign(nW, 0);
    holding.assign(nW, 0);
    port_val.assign(pW, 0); port_full.assign(pW, 0);
    stack_mem.assign((size_t)num_stacks * stack_cap * kGroupW, 0);
    stack_top.assign(sW, 0);
    in_buf.assign((size_t)in_cap * kGroupW, 0);
    out_buf.assign((size_t)out_cap * kGroupW, 0);
    f_ptr.assign(nW, nullptr);
    s_op.assign(nW, 0);
    s_src_val.assign(nW, 0);
    s_src_ok.assign(nW, 0);
    s_deliv_full.assign(pW, 0); s_deliv_val.assign(pW, 0);
    s_begin_top.assign(sW, 0);
    s_stack_taken.assign(sW, 0); s_pushed.assign(sW, 0);
    s_push_val.assign(sW, 0);
    std::memset(in_rd, 0, sizeof(in_rd));
    std::memset(in_wr, 0, sizeof(in_wr));
    std::memset(out_rd, 0, sizeof(out_rd));
    std::memset(out_wr, 0, sizeof(out_wr));
    std::memset(tick_count, 0, sizeof(tick_count));
  }
};

// Dimension/table traits: the group serve template reads every dimension
// and the program tables through one of these, so the SAME statements
// compile once against runtime fields (DynSpec) and once against the baked
// constexpr data of a specialized build (SpecSpec) — constant loop bounds
// unroll, the program reads from .rodata, and the two stay semantically
// identical by construction.
struct DynSpec {
  static constexpr bool is_spec = false;
  static inline int n_lanes(const Group& g) { return g.n_lanes; }
  static inline int max_len(const Group& g) { return g.max_len; }
  static inline int num_stacks(const Group& g) { return g.num_stacks; }
  static inline int stack_cap(const Group& g) { return g.stack_cap; }
  static inline int in_cap(const Group& g) { return g.in_cap; }
  static inline int out_cap(const Group& g) { return g.out_cap; }
  static inline const int32_t* code(const Group& g) { return g.code; }
  static inline const int32_t* prog_len(const Group& g) { return g.prog_len; }
};

#ifdef MISAKA_SPEC
struct SpecSpec {
  static constexpr bool is_spec = true;
  static inline constexpr int n_lanes(const Group&) { return spec::n_lanes; }
  static inline constexpr int max_len(const Group&) { return spec::max_len; }
  static inline constexpr int num_stacks(const Group&) {
    return spec::num_stacks;
  }
  static inline constexpr int stack_cap(const Group&) {
    return spec::stack_cap;
  }
  static inline constexpr int in_cap(const Group&) { return spec::in_cap; }
  static inline constexpr int out_cap(const Group&) { return spec::out_cap; }
  static inline const int32_t* code(const Group&) { return spec::code; }
  static inline const int32_t* prog_len(const Group&) {
    return spec::prog_len;
  }
};
#endif

#define MISAKA_AI inline __attribute__((always_inline))

// Per-tick ring/IO arbitration state shared between the tick passes: what
// pass 2 discovers (per-replica IN/OUT winners) and pass 3 applies.  A
// plain aggregate so the generated switch-threaded tick (specialize.py
// part 2) shares the exact prologue/epilogue code with the generic tick.
struct TickIO {
  uint8_t in_avail[kGroupW], out_free[kGroupW];
  uint8_t in_taken[kGroupW], out_taken[kGroupW];
  int32_t in_win[kGroupW], out_value[kGroupW];
};

// Scratch reset + begin-of-tick snapshots: runs after pass 1 (phase A),
// before arbitration.  Shared single-source with the specialized tick.
template <class S>
MISAKA_AI void tick_prologue(Group& g, TickIO& io) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ns = S::num_stacks(g);
  const int ocap = S::out_cap(g);
  std::memset(g.s_deliv_full.data(), 0, (size_t)n * kPorts * W);
  std::memcpy(g.s_begin_top.data(), g.stack_top.data(),
              (size_t)ns * W * sizeof(int32_t));
  std::memset(g.s_stack_taken.data(), 0, (size_t)ns * W);
  std::memset(g.s_pushed.data(), 0, (size_t)ns * W);
#pragma omp simd
  for (int r = 0; r < W; ++r) {
    io.in_avail[r] = (uint8_t)(g.in_wr[r] - g.in_rd[r] > 0);
    io.out_free[r] = (uint8_t)(g.out_wr[r] - g.out_rd[r] < ocap);
    io.in_taken[r] = io.out_taken[r] = 0;
    io.in_win[r] = -1;
    io.out_value[r] = 0;
  }
}

// pass 3 — apply resource effects (contiguous over the replica axis).
// Masked-out replicas never wrote arbitration scratch, so the port and
// stack loops are naturally no-ops for them; only the per-replica ring
// winners and the tick-count advance need the explicit gate.
template <class S, bool kMasked>
MISAKA_AI bool tick_epilogue(Group& g, TickIO& io, const uint8_t* moved,
                             const uint8_t* mask) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ns = S::num_stacks(g);
  const int scap = S::stack_cap(g);
  const int ocap = S::out_cap(g);
  {
    const size_t np = (size_t)n * kPorts * W;
#pragma omp simd
    for (size_t pi = 0; pi < np; ++pi) {
      if (g.s_deliv_full[pi]) {
        g.port_full[pi] = 1;
        g.port_val[pi] = g.s_deliv_val[pi];
      }
    }
  }
  for (int s = 0; s < ns; ++s) {
    for (int r = 0; r < W; ++r) {
      const size_t si = (size_t)s * W + r;
      if (g.s_pushed[si]) {
        g.stack_mem[((size_t)r * ns + s) * scap + g.s_begin_top[si]] =
            g.s_push_val[si];
        g.stack_top[si] = g.s_begin_top[si] + 1;
      } else if (g.s_stack_taken[si]) {
        g.stack_top[si] = g.s_begin_top[si] - 1;  // a granted POP
      }
    }
  }
  bool any = false;
  for (int r = 0; r < W; ++r) {
    if (kMasked && !mask[r]) continue;
    if (io.in_win[r] >= 0) g.in_rd[r] += 1;
    if (io.out_taken[r]) {
      g.out_buf[(size_t)r * ocap + g.out_wr[r] % ocap] = io.out_value[r];
      g.out_wr[r] += 1;
    }
    g.tick_count[r] = i32((int64_t)g.tick_count[r] + 1);  // wrap-safe
    any |= moved[r] != 0;
  }
  return any;
}

// One group tick: Interp::tick with the replica axis widened to kGroupW.
// Returns whether ANY masked-in replica progressed — a no-progress
// replica's tick is an identity step (determinism: it can never wake
// without external input), so lockstep over the group preserves
// per-replica bit-identity with the scalar engine's individual early
// exit.  kMasked gates replicas OUT of the tick entirely (partial fill on
// the resident path): a masked-out replica's state — registers, latches,
// ports, rings, tick count — is bit-untouched, exactly as if it had been
// left off a stateless call's active list.
template <class S, bool kMasked>
MISAKA_AI bool group_tick(Group& g, const uint8_t* mask) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ml = S::max_len(g);
  const int ns = S::num_stacks(g);
  const int scap = S::stack_cap(g);
  const int icap = S::in_cap(g);
  const int32_t* code = S::code(g);
  const int32_t* plen = S::prog_len(g);

  uint8_t moved[W];
  std::memset(moved, 0, sizeof(moved));
  constexpr uint32_t kReads =
      (1u << OP_MOV_LOCAL) | (1u << OP_MOV_NET) | (1u << OP_ADD) |
      (1u << OP_SUB) | (1u << OP_JRO) | (1u << OP_PUSH) | (1u << OP_OUT);

  // pass 1 — fetch + phase A + source resolution, fused per (lane,
  // replica): all three touch only the lane's OWN latch/registers, so
  // they need no cross-lane ordering.  The instruction pointer is cached
  // for pass 2 (pc is stable until commit).  Masked-out replicas still
  // resolve sources into scratch (harmless — pass 2 skips them) but must
  // never consume a port: that is a state change.
  for (int l = 0; l < n; ++l) {
    const int32_t* base = code + (size_t)l * ml * NFIELDS;
    for (int r = 0; r < W; ++r) {
      const int i = l * W + r;
      const int32_t* f = base + (size_t)g.pc[i] * NFIELDS;
      g.f_ptr[i] = f;
      const int op = f[F_OP], src = f[F_SRC];
      g.s_op[i] = op;
      const bool reads = (kReads >> op) & 1u;
      // phase A: consume a ready port source into the hold latch
      if (reads && src >= SRC_R0 && !g.holding[i] &&
          (!kMasked || mask[r])) {
        const size_t pi = (size_t)(l * kPorts + (src - SRC_R0)) * W + r;
        if (g.port_full[pi]) {
          g.hold_val[i] = g.port_val[pi];
          g.holding[i] = 1;
          g.port_full[pi] = 0;
          moved[r] = 1;
        }
      }
      // source resolution (post-consume holding, like the scalar engine)
      const int64_t v = (src == SRC_IMM) ? (int64_t)f[F_IMM]
                      : (src == SRC_ACC) ? g.acc[i]
                      : (src == SRC_NIL) ? (int64_t)0
                                         : (int64_t)g.hold_val[i];
      g.s_src_val[i] = reads ? v : 0;
      g.s_src_ok[i] =
          (uint8_t)(!reads || src < SRC_R0 || g.holding[i] != 0);
    }
  }

  TickIO io;
  tick_prologue<S>(g, io);

  // pass 2 — arbitration + commit, fused: lowest lane index wins each
  // per-replica resource, and since later lanes' grants can never change
  // an earlier lane's, the commit (register/pc effects reading
  // begin-of-tick acc/bak — each lane reads only its OWN, held in locals
  // before the update) runs in the same iteration.  Port/stack/ring
  // EFFECTS still wait for pass 3: sends must see post-consume,
  // pre-delivery occupancy, stack feasibility keys on begin-of-tick tops,
  // and IN reads the ring at the begin-of-tick read cursor.
  for (int l = 0; l < n; ++l) {
    const int32_t ln = plen[l];
    for (int r = 0; r < W; ++r) {
      if (kMasked && !mask[r]) continue;
      const int i = l * W + r;
      const int op = g.s_op[i];
      const int32_t* f = g.f_ptr[i];
      bool commit;
      int32_t pop_val = 0;
      switch (op) {
        case OP_MOV_NET: {
          commit = false;
          if (!g.s_src_ok[i]) break;
          const size_t pi = (size_t)(f[F_TGT] * kPorts + f[F_PORT]) * W + r;
          if (!g.port_full[pi] && !g.s_deliv_full[pi]) {
            g.s_deliv_full[pi] = 1;
            g.s_deliv_val[pi] = i32(g.s_src_val[i]);  // wire: sint32
            commit = true;
          }
          break;
        }
        case OP_PUSH: {
          commit = false;
          if (!g.s_src_ok[i]) break;
          const size_t si = (size_t)f[F_TGT] * W + r;
          if (!g.s_stack_taken[si] && g.s_begin_top[si] < scap) {
            g.s_stack_taken[si] = 1;
            g.s_pushed[si] = 1;
            g.s_push_val[si] = i32(g.s_src_val[i]);  // wire: sint32
            commit = true;
          }
          break;
        }
        case OP_POP: {
          commit = false;
          const int s = f[F_TGT];
          const size_t si = (size_t)s * W + r;
          if (!g.s_stack_taken[si] && g.s_begin_top[si] > 0) {
            g.s_stack_taken[si] = 1;
            pop_val = g.stack_mem[((size_t)r * ns + s) * scap +
                                  g.s_begin_top[si] - 1];
            commit = true;
          }
          break;
        }
        case OP_IN:
          commit = false;
          if (io.in_avail[r] && !io.in_taken[r]) {
            io.in_taken[r] = 1;
            io.in_win[r] = l;
            commit = true;
          }
          break;
        case OP_OUT:
          commit = false;
          if (g.s_src_ok[i] && io.out_free[r] && !io.out_taken[r]) {
            io.out_taken[r] = 1;
            io.out_value[r] = i32(g.s_src_val[i]);
            commit = true;
          }
          break;
        default:
          commit = g.s_src_ok[i] != 0;
          break;
      }
      if (!commit) continue;
      moved[r] = 1;
      const int64_t oa = g.acc[i], ob = g.bak[i];  // begin-of-tick values
      switch (op) {
        case OP_MOV_LOCAL:
          if (f[F_DST] == DST_ACC) g.acc[i] = g.s_src_val[i];
          break;
        case OP_ADD:
          g.acc[i] = (int64_t)((uint64_t)oa + (uint64_t)g.s_src_val[i]);
          break;
        case OP_SUB:
          g.acc[i] = (int64_t)((uint64_t)oa - (uint64_t)g.s_src_val[i]);
          break;
        case OP_NEG: g.acc[i] = (int64_t)(0 - (uint64_t)oa); break;
        case OP_SWP: g.acc[i] = ob; g.bak[i] = oa; break;
        case OP_SAV: g.bak[i] = oa; break;
        case OP_POP:
          if (f[F_DST] == DST_ACC) g.acc[i] = pop_val;
          break;
        case OP_IN:
          if (f[F_DST] == DST_ACC)
            g.acc[i] = g.in_buf[(size_t)r * icap + g.in_rd[r] % icap];
          break;
        default: break;
      }
      const bool taken = op == OP_JMP || (op == OP_JEZ && oa == 0) ||
                         (op == OP_JNZ && oa != 0) ||
                         (op == OP_JGZ && oa > 0) || (op == OP_JLZ && oa < 0);
      if (taken) {
        g.pc[i] = f[F_JMP];
      } else if (op == OP_JRO) {
        // 64-bit offset: saturate by sign past int32 (mirrors Interp)
        const int64_t v = g.s_src_val[i];
        const int64_t t = (v >= INT32_MIN && v <= INT32_MAX)
                              ? (int64_t)g.pc[i] + v
                              : (v < 0 ? 0 : (int64_t)ln - 1);
        g.pc[i] = (int32_t)(t < 0 ? 0 : (t > ln - 1 ? ln - 1 : t));
      } else {
        g.pc[i] = (g.pc[i] + 1) % ln;
      }
      g.holding[i] = 0;
      g.retired[i] = i32((int64_t)g.retired[i] + 1);  // wrap-safe
    }
  }

  return tick_epilogue<S, kMasked>(g, io, moved, mask);
}

// JIT group tick: the same three-pass superstep with every (lane, pc)
// instruction dispatched through its spliced machine-code fragment —
// fetch/decode, field reads, pc successors and arbitration indices are
// all baked into the code (native/stencils.cpp).  Pass 2 dispatches on
// the CURRENT pc (stable until its own fragment commits), exactly like
// the switch-threaded tick.  Masked-out replicas are skipped in BOTH
// passes: pass 1 for them only writes scratch that pass 2 (also skipped)
// would read, and phase-A port consumption must not happen — so skipping
// is bit-identical to the template tick's mask handling.
template <class S, bool kMasked>
MISAKA_AI bool group_tick_jit(Group& g, const uint8_t* mask) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ml = S::max_len(g);
  uint8_t moved[W];
  std::memset(moved, 0, sizeof(moved));
  TickIO io;
  MisakaJitCtx ctx = {
      g.acc.data(),          g.bak.data(),      g.pc.data(),
      g.hold_val.data(),     g.retired.data(),  g.holding.data(),
      g.port_val.data(),     g.port_full.data(), g.stack_mem.data(),
      g.in_buf.data(),       g.in_rd,           g.s_src_val.data(),
      g.s_src_ok.data(),     g.s_deliv_full.data(), g.s_deliv_val.data(),
      g.s_begin_top.data(),  g.s_stack_taken.data(), g.s_pushed.data(),
      g.s_push_val.data(),   moved,             io.in_avail,
      io.out_free,           io.in_taken,       io.out_taken,
      io.in_win,             io.out_value,
  };
  for (int l = 0; l < n; ++l) {
    const MisakaJitFn* lane = g.jit1 + (size_t)l * ml;
    const int32_t* pc = g.pc.data() + (size_t)l * W;
    for (int r = 0; r < W; ++r) {
      if (kMasked && !mask[r]) continue;
      lane[pc[r]](&ctx, (uint64_t)r);
    }
  }
  tick_prologue<S>(g, io);
  for (int l = 0; l < n; ++l) {
    const MisakaJitFn* lane = g.jit2 + (size_t)l * ml;
    const int32_t* pc = g.pc.data() + (size_t)l * W;
    for (int r = 0; r < W; ++r) {
      if (kMasked && !mask[r]) continue;
      lane[pc[r]](&ctx, (uint64_t)r);
    }
  }
  return tick_epilogue<S, kMasked>(g, io, moved, mask);
}

// Switch-threaded specialized tick (core/specialize.py, header part 2):
// the generated second section of the spec header defines
// misaka_spec_tick<kMasked>(Group&, const uint8_t*) — the SAME three-pass
// tick with every (lane, pc) instruction dispatched through a switch
// whose cases carry the instruction fields AND the pc successors as
// literals, so instruction fetch stops chasing per-replica pc through
// gathers entirely (the modulo pc advance folds to a constant too).  It
// is included HERE, after Group/TickIO/the pass helpers it calls, and
// shares tick_prologue/tick_epilogue so the resource-effect semantics
// stay single-source.  An r16-era cached header without part 2 simply
// never defines MISAKA_SPEC_SWITCH and keeps the generic template tick.
#if defined(MISAKA_SPEC) && defined(MISAKA_SPEC_SWITCH)
#define MISAKA_SPEC_PART2 1
#include MISAKA_SPEC_HEADER
#undef MISAKA_SPEC_PART2
#endif

template <class S, bool kMasked>
MISAKA_AI bool group_tick_for(Group& g, const uint8_t* mask) {
#if defined(MISAKA_SPEC) && defined(MISAKA_SPEC_SWITCH)
  if constexpr (S::is_spec) return misaka_spec_tick<kMasked>(g, mask);
#endif
  if (g.jit1 != nullptr) return group_tick_jit<S, kMasked>(g, mask);
  return group_tick<S, kMasked>(g, mask);
}

// interp_run widened to the group: early exit when NO masked-in replica
// progresses (per-replica quiescence is monotone, so identity steps
// before the group quiesces preserve bit-identity), tick counters topped
// up to exactly +ticks, ring counters rebased below the int32 wrap per
// replica.  Masked-out replicas are untouched throughout.
template <class S, bool kMasked>
MISAKA_AI void group_run(Group& g, int ticks, const uint8_t* mask) {
  constexpr int W = kGroupW;
  const int icap = S::in_cap(g);
  const int ocap = S::out_cap(g);
  int executed = 0;
  for (; executed < ticks;) {
    ++executed;
    if (!group_tick_for<S, kMasked>(g, mask)) break;
  }
  const int remaining = ticks - executed;
  const int32_t kThreshold = 1 << 30;
  for (int r = 0; r < W; ++r) {
    if (kMasked && !mask[r]) continue;
    if (remaining)
      g.tick_count[r] = i32((int64_t)g.tick_count[r] + remaining);
    if (g.in_rd[r] > kThreshold) {
      const int32_t base = (g.in_rd[r] / icap) * icap;
      g.in_rd[r] -= base;
      g.in_wr[r] -= base;
    }
    if (g.out_rd[r] > kThreshold) {
      const int32_t base = (g.out_rd[r] / ocap) * ocap;
      g.out_rd[r] -= base;
      g.out_wr[r] -= base;
    }
  }
}

// Validate one group's batch-major state slices — the exact checks
// write_state performs — plus (feeding) the ring-headroom check, WITHOUT
// touching the group.  Nonzero tells the caller to refuse an import or
// rerun the group down the scalar path.
template <class S>
MISAKA_AI int group_validate(const Group& g, const Job& j, int rep0) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ns = S::num_stacks(g);
  const int scap = S::stack_cap(g);
  const int icap = S::in_cap(g);
  const int ocap = S::out_cap(g);
  const int32_t* plen = S::prog_len(g);
  for (int r = 0; r < W; ++r) {
    const int rep = rep0 + r;
    const int32_t* pc = j.pc + (size_t)rep * n;
    for (int l = 0; l < n; ++l)
      if (pc[l] < 0 || pc[l] >= plen[l]) return 1;
    const int32_t* top = j.stack_top + (size_t)rep * ns;
    for (int s = 0; s < ns; ++s)
      if (top[s] < 0 || top[s] > scap) return 1;
    const int32_t* c = j.counters + (size_t)rep * 5;
    if (c[0] < 0 || c[1] < c[0] || c[1] - c[0] > icap || c[2] < 0 ||
        c[3] < c[2] || c[3] - c[2] > ocap)
      return 1;
    if (j.feeding) {
      const int count = j.feed_counts[rep];
      if (count > icap - (c[1] - c[0])) return 1;  // scalar path reports -2
    }
  }
  return 0;
}

// Import: transpose batch-major slices into the SoA planes (the caller
// validated first).
template <class S>
MISAKA_AI void group_import(Group& g, const Job& j, int rep0) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ns = S::num_stacks(g);
  const int scap = S::stack_cap(g);
  const int icap = S::in_cap(g);
  const int ocap = S::out_cap(g);
  for (int r = 0; r < W; ++r) {
    const int rep = rep0 + r;
    const int32_t* a = j.acc + (size_t)rep * n;
    const int32_t* ah = j.acc_hi + (size_t)rep * n;
    const int32_t* b = j.bak + (size_t)rep * n;
    const int32_t* bh = j.bak_hi + (size_t)rep * n;
    const int32_t* pc = j.pc + (size_t)rep * n;
    const int32_t* hv = j.hold_val + (size_t)rep * n;
    const uint8_t* ho = j.holding + (size_t)rep * n;
    const int32_t* rt = j.retired + (size_t)rep * n;
    for (int l = 0; l < n; ++l) {
      const int i = l * W + r;
      g.acc[i] =
          (int64_t)(((uint64_t)(uint32_t)ah[l] << 32) | (uint32_t)a[l]);
      g.bak[i] =
          (int64_t)(((uint64_t)(uint32_t)bh[l] << 32) | (uint32_t)b[l]);
      g.pc[i] = pc[l];
      g.hold_val[i] = hv[l];
      g.holding[i] = ho[l] ? 1 : 0;
      g.retired[i] = rt[l];
    }
    const int32_t* pv = j.port_val + (size_t)rep * n * kPorts;
    const uint8_t* pf = j.port_full + (size_t)rep * n * kPorts;
    for (int x = 0; x < n * kPorts; ++x) {
      g.port_val[(size_t)x * W + r] = pv[x];
      g.port_full[(size_t)x * W + r] = pf[x] ? 1 : 0;
    }
    const int32_t* st = j.stack_top + (size_t)rep * ns;
    for (int s = 0; s < ns; ++s) g.stack_top[(size_t)s * W + r] = st[s];
    // replica-major planes: straight memcpys (above-top stack residue is
    // never read — pushes land AT the top, pops read below it)
    std::memcpy(&g.stack_mem[(size_t)r * ns * scap],
                j.stack_mem + (size_t)rep * ns * scap,
                (size_t)ns * scap * 4);
    std::memcpy(&g.in_buf[(size_t)r * icap],
                j.in_buf + (size_t)rep * icap, (size_t)icap * 4);
    std::memcpy(&g.out_buf[(size_t)r * ocap],
                j.out_buf + (size_t)rep * ocap, (size_t)ocap * 4);
    const int32_t* c = j.counters + (size_t)rep * 5;
    g.in_rd[r] = c[0];
    g.in_wr[r] = c[1];
    g.out_rd[r] = c[2];
    g.out_wr[r] = c[3];
    g.tick_count[r] = c[4];
  }
}

// Feed masked-in replicas' pending values into their input rings (the
// caller checked headroom).
template <class S, bool kMasked>
MISAKA_AI void group_feed(Group& g, const Job& j, int rep0,
                          const uint8_t* mask) {
  constexpr int W = kGroupW;
  const int icap = S::in_cap(g);
  for (int r = 0; r < W; ++r) {
    if (kMasked && !mask[r]) continue;
    const int rep = rep0 + r;
    const int count = j.feed_counts[rep];
    const int32_t* vals = j.feed_vals + (size_t)rep * icap;
    for (int k = 0; k < count; ++k) {
      g.in_buf[(size_t)r * icap + g.in_wr[r] % icap] = vals[k];
      g.in_wr[r] += 1;
    }
  }
}

// Pack the post-run snapshot rows (serve: counters + ring, then drain;
// idle: counters only, ring untouched).
template <class S>
MISAKA_AI void group_pack(Group& g, const Job& j, int rep0) {
  constexpr int W = kGroupW;
  const int ocap = S::out_cap(g);
  if (j.feeding) {
    for (int r = 0; r < W; ++r) {
      int32_t* row = j.packed + (size_t)(rep0 + r) * (4 + ocap);
      row[0] = g.in_rd[r];
      row[1] = g.in_wr[r];
      row[2] = g.out_rd[r];
      row[3] = g.out_wr[r];
      std::memcpy(row + 4, &g.out_buf[(size_t)r * ocap],
                  (size_t)ocap * 4);
      g.out_rd[r] = g.out_wr[r];  // drain AFTER the snapshot (device parity)
    }
  } else {
    for (int r = 0; r < W; ++r) {
      int32_t* row = j.packed + (size_t)(rep0 + r) * 4;
      row[0] = g.in_rd[r];
      row[1] = g.in_wr[r];
      row[2] = g.out_rd[r];
      row[3] = g.out_wr[r];  // idle: counters only, ring untouched
    }
  }
}

// Export: transpose the SoA planes back into the batch-major slices.
template <class S>
MISAKA_AI void group_export(Group& g, const Job& j, int rep0) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int ns = S::num_stacks(g);
  const int scap = S::stack_cap(g);
  const int icap = S::in_cap(g);
  const int ocap = S::out_cap(g);
  for (int r = 0; r < W; ++r) {
    const int rep = rep0 + r;
    int32_t* a = j.acc + (size_t)rep * n;
    int32_t* ah = j.acc_hi + (size_t)rep * n;
    int32_t* b = j.bak + (size_t)rep * n;
    int32_t* bh = j.bak_hi + (size_t)rep * n;
    int32_t* pc = j.pc + (size_t)rep * n;
    int32_t* hv = j.hold_val + (size_t)rep * n;
    uint8_t* ho = j.holding + (size_t)rep * n;
    int32_t* rt = j.retired + (size_t)rep * n;
    for (int l = 0; l < n; ++l) {
      const int i = l * W + r;
      a[l] = i32(g.acc[i]);
      ah[l] = (int32_t)(g.acc[i] >> 32);
      b[l] = i32(g.bak[i]);
      bh[l] = (int32_t)(g.bak[i] >> 32);
      pc[l] = g.pc[i];
      hv[l] = g.hold_val[i];
      ho[l] = g.holding[i];
      rt[l] = g.retired[i];
    }
    int32_t* pv = j.port_val + (size_t)rep * n * kPorts;
    uint8_t* pf = j.port_full + (size_t)rep * n * kPorts;
    for (int x = 0; x < n * kPorts; ++x) {
      pv[x] = g.port_val[(size_t)x * W + r];
      pf[x] = g.port_full[(size_t)x * W + r];
    }
    int32_t* sm = j.stack_mem + (size_t)rep * ns * scap;
    int32_t* st = j.stack_top + (size_t)rep * ns;
    for (int s = 0; s < ns; ++s) {
      const int32_t top = g.stack_top[(size_t)s * W + r];
      st[s] = top;
      // live slots + explicit zero pad above the top (read_state parity)
      std::memcpy(sm + (size_t)s * scap,
                  &g.stack_mem[((size_t)r * ns + s) * scap], (size_t)top * 4);
      std::memset(sm + (size_t)s * scap + top, 0, (size_t)(scap - top) * 4);
    }
    std::memcpy(j.in_buf + (size_t)rep * icap,
                &g.in_buf[(size_t)r * icap], (size_t)icap * 4);
    std::memcpy(j.out_buf + (size_t)rep * ocap,
                &g.out_buf[(size_t)r * ocap], (size_t)ocap * 4);
    int32_t* c = j.counters + (size_t)rep * 5;
    c[0] = g.in_rd[r];
    c[1] = g.in_wr[r];
    c[2] = g.out_rd[r];
    c[3] = g.out_wr[r];
    c[4] = g.tick_count[r];
  }
}

// One full STATELESS group serve/idle: validate -> import -> feed -> run
// -> pack/drain -> export.  Mirrors Pool::serve_replica exactly.  Returns
// 0 on success; any validation or feed-capacity violation returns nonzero
// BEFORE touching the job arrays, and the caller reruns the whole group
// down the scalar per-replica path so error codes and partial-failure
// state semantics stay byte-identical to the shipped engine.
template <class S>
MISAKA_AI int group_serve(Group& g, const Job& j, int rep0) {
  if (group_validate<S>(g, j, rep0)) return 1;
  group_import<S>(g, j, rep0);
  if (j.feeding) group_feed<S, false>(g, j, rep0, nullptr);
  group_run<S, false>(g, j.ticks, nullptr);
  group_pack<S>(g, j, rep0);
  group_export<S>(g, j, rep0);
  return 0;
}

// One RESIDENT group serve/idle (r17): state lives in `g` between calls —
// no import, no export, no transpose.  `mask` (null = every replica)
// gates which replicas tick; a masked-out row keeps its state untouched
// but still gets its packed row filled — current counters, plus the
// drained-on-serve contract for an undrained ring on a feeding pass
// (exactly what the Python caller used to prefill from its own copy of
// the counters, which residency no longer has).  Returns 0, or -2 when a
// feed exceeds a ring's free space — checked for the WHOLE group before
// any effect, so a failed call leaves the resident state bit-untouched.
template <class S>
MISAKA_AI int group_serve_resident(Group& g, const Job& j, int rep0,
                                   const uint8_t* mask) {
  constexpr int W = kGroupW;
  const int n = S::n_lanes(g);
  const int icap = S::in_cap(g);
  const int ocap = S::out_cap(g);
  if (j.feeding) {
    for (int r = 0; r < W; ++r) {
      if (mask != nullptr && !mask[r]) continue;
      if (j.feed_counts[rep0 + r] > icap - (g.in_wr[r] - g.in_rd[r]))
        return -2;
    }
  }
  int64_t retired0[W];
  if (j.progress != nullptr) {
    for (int r = 0; r < W; ++r) {
      int64_t s = 0;
      for (int l = 0; l < n; ++l) s += g.retired[(size_t)l * W + r];
      retired0[r] = s;
    }
  }
  if (mask != nullptr) {
    if (j.feeding) group_feed<S, true>(g, j, rep0, mask);
    group_run<S, true>(g, j.ticks, mask);
  } else {
    if (j.feeding) group_feed<S, false>(g, j, rep0, nullptr);
    group_run<S, false>(g, j.ticks, nullptr);
  }
  for (int r = 0; r < W; ++r) {
    const int rep = rep0 + r;
    const bool on = mask == nullptr || mask[r] != 0;
    if (j.feeding) {
      int32_t* row = j.packed + (size_t)rep * (4 + ocap);
      row[0] = g.in_rd[r];
      row[1] = g.in_wr[r];
      row[2] = g.out_rd[r];
      row[3] = g.out_wr[r];
      if (on || g.out_wr[r] > g.out_rd[r]) {
        std::memcpy(row + 4, &g.out_buf[(size_t)r * ocap],
                    (size_t)ocap * 4);
        g.out_rd[r] = g.out_wr[r];  // drain AFTER the snapshot
      }
    } else {
      int32_t* row = j.packed + (size_t)rep * 4;
      row[0] = g.in_rd[r];
      row[1] = g.in_wr[r];
      row[2] = g.out_rd[r];
      row[3] = g.out_wr[r];
    }
    if (j.progress != nullptr) {
      int64_t s = 0;
      for (int l = 0; l < n; ++l) s += g.retired[(size_t)l * W + r];
      j.progress[rep] = (uint8_t)(on && s != retired0[r]);
    }
  }
  return 0;
}

// The templates instantiated through target wrappers: the avx2 variants
// get AVX2 codegen for the always-inlined bodies (runtime-selected), the
// plain ones are the scalar fallback from the SAME templates.
using GroupServeFn = int (*)(Group&, const Job&, int);
using GroupResidentFn = int (*)(Group&, const Job&, int, const uint8_t*);

int group_serve_dyn_plain(Group& g, const Job& j, int rep0) {
  return group_serve<DynSpec>(g, j, rep0);
}
int group_resident_dyn_plain(Group& g, const Job& j, int rep0,
                             const uint8_t* mask) {
  return group_serve_resident<DynSpec>(g, j, rep0, mask);
}
#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("avx2"))) int group_serve_dyn_avx2(Group& g,
                                                         const Job& j,
                                                         int rep0) {
  return group_serve<DynSpec>(g, j, rep0);
}
__attribute__((target("avx2"))) int group_resident_dyn_avx2(
    Group& g, const Job& j, int rep0, const uint8_t* mask) {
  return group_serve_resident<DynSpec>(g, j, rep0, mask);
}
#endif
#ifdef MISAKA_SPEC
int group_serve_spec_plain(Group& g, const Job& j, int rep0) {
  return group_serve<SpecSpec>(g, j, rep0);
}
int group_resident_spec_plain(Group& g, const Job& j, int rep0,
                              const uint8_t* mask) {
  return group_serve_resident<SpecSpec>(g, j, rep0, mask);
}
#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("avx2"))) int group_serve_spec_avx2(Group& g,
                                                          const Job& j,
                                                          int rep0) {
  return group_serve<SpecSpec>(g, j, rep0);
}
__attribute__((target("avx2"))) int group_resident_spec_avx2(
    Group& g, const Job& j, int rep0, const uint8_t* mask) {
  return group_serve_resident<SpecSpec>(g, j, rep0, mask);
}
#endif
#endif

GroupServeFn pick_group_fn(SimdMode mode, bool specialized) {
  (void)specialized;
#ifdef MISAKA_SPEC
  if (specialized) {
#if defined(__x86_64__) || defined(__i386__)
    if (mode == SIMD_AVX2) return group_serve_spec_avx2;
#endif
    return group_serve_spec_plain;
  }
#endif
#if defined(__x86_64__) || defined(__i386__)
  if (mode == SIMD_AVX2) return group_serve_dyn_avx2;
#endif
  return group_serve_dyn_plain;
}

GroupResidentFn pick_resident_fn(SimdMode mode, bool specialized) {
  (void)specialized;
#ifdef MISAKA_SPEC
  if (specialized) {
#if defined(__x86_64__) || defined(__i386__)
    if (mode == SIMD_AVX2) return group_resident_spec_avx2;
#endif
    return group_resident_spec_plain;
  }
#endif
#if defined(__x86_64__) || defined(__i386__)
  if (mode == SIMD_AVX2) return group_resident_dyn_avx2;
#endif
  return group_resident_dyn_plain;
}

// Plain-codegen instantiations for the lifecycle paths (import/export are
// transpose memcpys — rare, never hot, no avx2 wrapper needed).
int group_import_checked(Group& g, const Job& j, int rep0) {
  if (group_validate<DynSpec>(g, j, rep0)) return -1;
  group_import<DynSpec>(g, j, rep0);
  return 0;
}
void group_export_plain(Group& g, const Job& j, int rep0) {
  group_export<DynSpec>(g, j, rep0);
}

#ifdef MISAKA_SPEC
// Does the runtime network match the baked one?  A mismatch silently
// degrades to the generic paths: a stale or mis-keyed cache entry must
// never execute another program's baked tables.
bool spec_matches(const int32_t* code, const int32_t* prog_len, int n_lanes,
                  int max_len, int num_stacks, int stack_cap, int in_cap,
                  int out_cap) {
  if (n_lanes != spec::n_lanes || max_len != spec::max_len ||
      num_stacks != spec::num_stacks || stack_cap != spec::stack_cap ||
      in_cap != spec::in_cap || out_cap != spec::out_cap)
    return false;
  return std::memcmp(code, spec::code,
                     (size_t)n_lanes * max_len * NFIELDS * 4) == 0 &&
         std::memcmp(prog_len, spec::prog_len, (size_t)n_lanes * 4) == 0;
}
#endif

// --- multi-threaded replica pool: the host THROUGHPUT tier -----------------
//
// B independent network replicas (the host analog of the engine's vmap batch
// axis) served by a persistent pool of OS threads.  Replicas are
// embarrassingly parallel — the TIS network is deterministic per instance and
// instances never share ports, stacks, or rings — so one pool_serve call
// shards the replica range across threads via an atomic index dispenser and
// barriers before returning.  The dispensed unit is a GROUP of kGroupW
// replicas on the SIMD path (full groups only — partial groups, the batch
// remainder, and the whole pool under MISAKA_SIMD=0 go per-replica through
// the scalar Interp).  Each replica's serve iteration mirrors the device
// batched twins (core/engine.py make_batched_serve), keeping the master's
// canonical state the NetworkState pytree:
//
//   serve: import slice -> feed -> run ticks -> packed row
//          [in_rd, in_wr, out_rd, out_wr, out_buf...] -> drain -> export
//   idle:  import slice -> run ticks -> counters row (ring NOT drained)
//
// All state arrays are batch-major ([B, ...] contiguous), so a replica's
// slice is a pointer offset — no per-replica marshalling on the Python side.

inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// --- native flight recorder (r18) ------------------------------------------
//
// Bounded lock-free per-thread event rings: every worker (plus the
// calling thread, slot == threads) journals steady-clock-stamped
// fixed-size records of what the serving hot path actually did —
// serve-call lifecycle, dispenser wait phases (spin / yield / park),
// per-unit tick execution tagged by engine rung, residency
// import/export.  A writer owns its ring exclusively: it fills the
// record with relaxed atomic stores (plain movs on x86 — no rmw, no
// lock) and publishes with ONE release store of the ring cursor; readers
// (misaka_pool_trace_read, called from Python scrape threads) acquire
// the cursor, copy, and re-read it — any record the writer lapped during
// the copy is discarded as torn, so a snapshot never stops the pool and
// never observes a half-written record.  MISAKA_NATIVE_TRACE=0 skips
// ring allocation entirely and every emit site reduces to one relaxed
// flag load + branch (misaka_pool_trace_set can flip a BUILT recorder
// at runtime for overhead A/Bs).  Memory bound: (threads + 1) rings x
// MISAKA_NATIVE_TRACE_RING (default 2048) x 32 B = 64 KiB per thread.

enum TraceEv {
  TEV_SERVE = 1,    // one pool serve/idle call (caller ring); arg =
                    // active replicas | flags<<32 (1 feeding, 2 resident,
                    // 4 inline — never published to workers)
  TEV_UNIT = 2,     // one dispensed unit executed; arg = replicas |
                    // shape<<24 (0 group, 1 scalar/remainder, 2 masked) |
                    // rung<<27 (0 scalar, 1 generic, 2 avx2, 4 = +spec) |
                    // first replica/group index<<32
  TEV_SPIN = 3,     // dispenser wait phases between jobs (worker rings):
  TEV_YIELD = 4,    //   pause-spin, yield-spin, futex park — the ladder
  TEV_PARK = 5,     //   split of one inter-job wait
  TEV_IMPORT = 6,   // residency armed from batch-major arrays; arg = B |
                    // (nonzero rc)<<32
  TEV_EXPORT = 7,   // resident state materialized (lifecycle read)
  TEV_DISCARD = 8,  // residency disarmed without export (state replaced)
};

constexpr int kTraceRecWords = 4;  // [t0_ns, dur_ns, kind, arg]

// per-unit rung/shape tags (TEV_UNIT arg + the tr_reps aggregate index)
enum { TSHAPE_GROUP = 0, TSHAPE_SCALAR = 1, TSHAPE_MASKED = 2 };
enum { TRUNG_SCALAR = 0, TRUNG_GENERIC = 1, TRUNG_AVX2 = 2,
       TRUNG_SPEC_BIT = 4, TRUNG_JIT_BIT = 8 };
constexpr int kTraceRungs = 16;  // bit 2 = specialized, bit 3 = jit
constexpr int kTraceShapes = 4;  // shape in [0, 3], one spare

struct Pool {
  using Job = ::Job;

  // `replicas` holds the per-replica scalar interpreters.  On the
  // STATELESS path they are never touched — scalar units run on
  // per-thread scratch interpreters — because on the RESIDENT path (r17)
  // they ARE the authoritative store for the replicas outside the
  // group-aligned range (res_groups covers [0, group_cover)): a stateless
  // call (validate_state, a fallback serve) arriving while residency is
  // armed must leave the resident state bit-untouched.
  std::vector<Interp*> replicas;
  std::vector<Interp*> scratch_interps;  // [threads + 1]: workers + caller
  std::vector<std::thread> workers;

  // --- flat futex/spin dispenser (see the primitives above) ---
  std::atomic<uint32_t> job_seq{0};
  std::atomic<uint32_t> done_seq{0};
  std::atomic<int> active_workers{0};
  std::atomic<int> parked{0};
  std::atomic<uint32_t> stop{0};
  std::atomic<int> next{0};
  int64_t spin_ns = 50 * 1000;  // MISAKA_POOL_SPIN_US overrides

  // Work units: `count` consecutive replicas (U_SCALAR/U_RES_SCALAR) or
  // groups (U_GROUP/U_RES_GROUP) per dispense.  build_units sizes the
  // count adaptively — ~4 units per thread at full batch (bounds both
  // dispenser traffic and the tail thread's wall: the last unit is
  // ~1/(4T) of the job), collapsing to single groups under partial fill
  // so the tail never holds more than one group over its siblings.
  struct Unit { int32_t kind; int32_t idx; int32_t count; };
  enum { U_SCALAR = 0, U_GROUP = 1, U_RES_GROUP = 2, U_RES_MASKED = 3,
         U_RES_SCALAR = 4 };
  SimdMode simd_mode = SIMD_OFF;
  bool specialized = false;
  GroupServeFn group_fn = nullptr;
  GroupResidentFn resident_fn = nullptr;
  std::vector<Group*> scratch_groups;  // [threads + 1], stateless scratch
  std::vector<Unit> units;
  // Per-replica result codes (each slot written by exactly one worker):
  // run_job reports the LOWEST-INDEX failure, so a mixed-failure batch
  // raises the same Python exception on every run instead of whichever
  // worker's atomic store landed last.
  std::vector<int> rep_rc;
  Job job;

  // --- resident state (r17) ---
  // When armed, the authoritative batch state lives HERE between serve
  // calls: res_groups owns the group-aligned replica range in SoA planes
  // (so a resident serve pays zero import/export transposition), the
  // `replicas` interpreters own the remainder, and serve calls run
  // feed/tick/pack in place.  Lifecycle paths export on demand
  // (misaka_pool_export) and state replacement discards
  // (misaka_pool_discard).
  bool resident = false;
  int group_cover = 0;             // replicas resident in res_groups
  std::vector<Group*> res_groups;  // built lazily at first import
  std::vector<uint8_t> res_mask;   // [B] active-mask scratch
  // Fully-skipped resident replicas, as [start, start+count) runs: for a
  // sparse active set the skipped rows are a handful of long contiguous
  // ranges, and the elision pass scans each run's dirty bytes with
  // memchr instead of a per-row loop.
  std::vector<std::pair<int32_t, int32_t>> res_skipped;

  // --- copy-and-patch JIT (r21) ---
  // Fragment tables copied from the caller at arm time (the exec buffer
  // they point into is owned Python-side and outlives the armed window by
  // caller contract; arm/disarm only run between serve calls).
  bool jit_armed = false;
  std::vector<MisakaJitFn> jit_tab1, jit_tab2;

  void apply_jit(Group* g) const {
    g->jit1 = jit_armed ? jit_tab1.data() : nullptr;
    g->jit2 = jit_armed ? jit_tab2.data() : nullptr;
  }

  // --- pack-row elision (r21) ---
  // dirty flag per (replica, row kind): 0 means the caller's REUSED
  // packed buffer already holds this replica's current counters row (and,
  // for the serve kind, that its out ring was empty when written — a row
  // holding undrained outputs must not be served twice).  pack_skipped
  // elides the write for clean rows; anything that advances a replica —
  // a resident unit running it, a drain, a state import — re-dirties it.
  // Workers touch disjoint replica slots, so plain bytes suffice.
  bool elide_on = true;  // MISAKA_PACK_ELIDE=0 kills
  std::vector<uint8_t> pack_dirty_serve, pack_dirty_idle;
  int64_t call_elided = 0, call_skip_packed = 0;  // caller-thread scratch
  std::atomic<int64_t> elided_rows{0}, skip_packed_rows{0};

  void mark_all_dirty() {
    if (pack_dirty_serve.empty()) return;
    std::memset(pack_dirty_serve.data(), 1, pack_dirty_serve.size());
    std::memset(pack_dirty_idle.data(), 1, pack_dirty_idle.size());
  }

  // Per-thread busy/idle nanosecond counters (the usage-accounting plane,
  // misaka_tpu/runtime/usage.py): `busy` accumulates time a worker spends
  // executing replica supersteps, `idle` the time it spins/parks awaiting
  // work — MEASURED native attribution, so "time in the C++ pool" is a
  // counter read, not an inference from Python-side wall clocks.
  // serial_busy_ns covers work on the CALLING thread (the small-pass fast
  // path, and the caller helping drain the unit list while it waits).
  // Atomics: readers (misaka_pool_counters) run concurrently with serving
  // without any pool lock.
  std::vector<std::atomic<int64_t>> busy_ns, idle_ns;
  std::atomic<int64_t> serial_busy_ns{0};

  // --- flight recorder (see the r18 block above) ---
  bool trace_built = false;           // rings allocated at create
  std::atomic<uint32_t> trace_armed{0};
  int trace_cap = 0;                  // records per ring
  std::vector<std::atomic<int64_t>> trace_buf;   // [(T+1) * cap * 4]
  std::vector<std::atomic<uint64_t>> trace_cur;  // [T+1] ring cursors
  // aggregate stats for the metrics plane (relaxed atomics, scrape-read):
  std::atomic<int64_t> tr_spin_ns{0}, tr_yield_ns{0}, tr_park_ns{0};
  std::atomic<int64_t> tr_wakes{0};
  std::atomic<int64_t> tr_dispatch_calls{0}, tr_dispatch_wait_ns{0};
  std::atomic<int64_t> tr_last_wait_ns{0}, tr_last_imbalance{0};
  std::atomic<int64_t> tr_caller_units{0};
  std::atomic<int64_t> tr_serve_calls{0}, tr_inline_calls{0};
  std::atomic<int64_t> tr_reps[kTraceRungs * kTraceShapes]{};
  // units each slot drained this published job (slot-exclusive plain
  // writes; the caller reads them after the done_seq acquire, so the
  // dispenser's own handshake is the fence)
  std::vector<int32_t> units_call;

  bool tracing() const {
    return trace_armed.load(std::memory_order_relaxed) != 0;
  }

  void tr_emit(int slot, int64_t t0, int64_t dur, int64_t kind,
               int64_t arg) {
    std::atomic<uint64_t>& cur = trace_cur[slot];
    const uint64_t c = cur.load(std::memory_order_relaxed);
    std::atomic<int64_t>* r = &trace_buf[
        ((size_t)slot * trace_cap + (size_t)(c % (uint64_t)trace_cap)) *
        kTraceRecWords];
    r[0].store(t0, std::memory_order_relaxed);
    r[1].store(dur, std::memory_order_relaxed);
    r[2].store(kind, std::memory_order_relaxed);
    r[3].store(arg, std::memory_order_relaxed);
    cur.store(c + 1, std::memory_order_release);
  }

  int group_rung() const {
    int rung = simd_mode == SIMD_AVX2 ? TRUNG_AVX2 : TRUNG_GENERIC;
    if (specialized) rung |= TRUNG_SPEC_BIT;
    if (jit_armed) rung |= TRUNG_JIT_BIT;
    return rung;
  }

  // One serve-call lifecycle record + counters; rc passes through so the
  // run_job exits stay one-line returns.  flags: 1 feeding, 2 resident,
  // 4 inline (the call never published to workers).
  int finish_serve(int rc, int64_t t_call, int n, int64_t flags) {
    if (t_call != 0) {
      tr_serve_calls.fetch_add(1, std::memory_order_relaxed);
      if (flags & 4) tr_inline_calls.fetch_add(1, std::memory_order_relaxed);
      tr_emit((int)workers.size(), t_call, now_ns() - t_call, TEV_SERVE,
              (int64_t)(uint32_t)n | (flags << 32));
    }
    return rc;
  }

  ~Pool() {
    stop.store(1, std::memory_order_seq_cst);
    job_seq.fetch_add(1, std::memory_order_seq_cst);  // pop spinners
    futex_wake_u32(&job_seq, INT_MAX);
    for (auto& w : workers) w.join();
    for (auto* it : replicas) delete it;
    for (auto* it : scratch_interps) delete it;
    for (auto* g : scratch_groups) delete g;
    for (auto* g : res_groups) delete g;
  }

  void serve_unit(const Unit& u, int slot) {
    if (!tracing()) {
      serve_unit_body(u, slot);
      return;
    }
    const int64_t t0 = now_ns();
    serve_unit_body(u, slot);
    const int64_t dur = now_ns() - t0;
    int rung = TRUNG_SCALAR, shape = TSHAPE_SCALAR;
    int64_t reps = u.count;
    switch (u.kind) {
      case U_GROUP:
      case U_RES_GROUP:
        rung = group_rung();
        shape = TSHAPE_GROUP;
        reps = (int64_t)u.count * kGroupW;
        break;
      case U_RES_MASKED: {
        rung = group_rung();
        shape = TSHAPE_MASKED;
        int cnt = 0;
        for (int r = 0; r < kGroupW; ++r)
          cnt += res_mask[(size_t)u.idx * kGroupW + r] != 0;
        reps = cnt;
        break;
      }
      default:
        break;  // U_SCALAR / U_RES_SCALAR: scalar rung, remainder shape
    }
    tr_reps[rung * kTraceShapes + shape].fetch_add(
        reps, std::memory_order_relaxed);
    // per-job unit counts feed the imbalance read, which spans WORKER
    // slots only — the caller slot is tracked on tr_caller_units (and a
    // units_call entry the inline paths never reset would overflow)
    if (slot < (int)workers.size()) units_call[slot] += 1;
    else tr_caller_units.fetch_add(1, std::memory_order_relaxed);
    tr_emit(slot, t0, dur, TEV_UNIT,
            (reps & 0xffffff) | ((int64_t)shape << 24) |
                ((int64_t)rung << 27) | ((int64_t)(uint32_t)u.idx << 32));
  }

  void serve_unit_body(const Unit& u, int slot) {
    switch (u.kind) {
      case U_SCALAR:
        for (int k = 0; k < u.count; ++k)
          rep_rc[u.idx + k] =
              serve_replica(u.idx + k, scratch_interps[slot]);
        break;
      case U_GROUP:
        for (int k = 0; k < u.count; ++k) {
          const int rep0 = (u.idx + k) * kGroupW;
          if (group_fn(*scratch_groups[slot], job, rep0) != 0) {
            // validation/feed-capacity violation: rerun the whole group
            // down the scalar path so per-replica error codes and
            // untouched-state semantics match the shipped engine exactly
            // (the group path bailed before writing anything back)
            for (int r = 0; r < kGroupW; ++r)
              rep_rc[rep0 + r] =
                  serve_replica(rep0 + r, scratch_interps[slot]);
          }
        }
        break;
      case U_RES_GROUP:
        for (int k = 0; k < u.count; ++k) {
          const int gi = u.idx + k;
          rep_rc[gi * kGroupW] =
              resident_fn(*res_groups[gi], job, gi * kGroupW, nullptr);
          mark_unit_dirty(gi * kGroupW, kGroupW);
        }
        break;
      case U_RES_MASKED:
        rep_rc[u.idx * kGroupW] =
            resident_fn(*res_groups[u.idx], job, u.idx * kGroupW,
                        res_mask.data() + (size_t)u.idx * kGroupW);
        mark_unit_dirty(u.idx * kGroupW, kGroupW);
        break;
      case U_RES_SCALAR:
        for (int k = 0; k < u.count; ++k)
          rep_rc[u.idx + k] = serve_replica_resident(u.idx + k);
        mark_unit_dirty(u.idx, u.count);
        break;
    }
  }

  // A resident unit wrote fresh pack rows for [rep0, rep0+count) and may
  // have advanced/drained them: the cached rows of BOTH kinds are stale
  // until pack_skipped rewrites them on a later call.  Conservative (an
  // active replica's row is rewritten next call anyway); each rep slot is
  // written by exactly one worker, disjoint from the caller's skipped set.
  void mark_unit_dirty(int rep0, int count) {
    if (pack_dirty_serve.empty()) return;
    std::memset(pack_dirty_serve.data() + rep0, 1, (size_t)count);
    std::memset(pack_dirty_idle.data() + rep0, 1, (size_t)count);
  }

  void run_units(int slot) {
    const int nu = (int)units.size();
    for (int u; (u = next.fetch_add(1, std::memory_order_relaxed)) < nu;)
      serve_unit(units[u], slot);
  }

  void worker_main(int tid) {
    uint32_t seen = 0;
    for (;;) {
      const int64_t t_park = now_ns();
      uint32_t cur;
      while ((cur = job_seq.load(std::memory_order_acquire)) == seen) {
        if (stop.load(std::memory_order_relaxed) != 0) return;
        const int64_t waited = now_ns() - t_park;
        if (waited < spin_ns) {
          // pause-spin briefly (the inter-call gap under load), then
          // YIELD-spin: on an oversubscribed/few-core box a pure pause
          // spin starves the very thread it is waiting on
          if (waited < 2000) cpu_pause();
          else std::this_thread::yield();
          continue;
        }
        // park: increment-recheck-wait pairs with the publisher's
        // store-then-read of `parked`, so a wake is never lost
        parked.fetch_add(1, std::memory_order_seq_cst);
        if (job_seq.load(std::memory_order_seq_cst) == seen &&
            stop.load(std::memory_order_seq_cst) == 0)
          futex_wait_u32(&job_seq, seen);
        parked.fetch_sub(1, std::memory_order_seq_cst);
      }
      seen = cur;
      if (stop.load(std::memory_order_relaxed) != 0) return;
      const int64_t t_work = now_ns();
      const int64_t waited = t_work - t_park;
      idle_ns[tid].fetch_add(waited, std::memory_order_relaxed);
      if (tracing()) {
        // split the wait along the ladder worker_main actually ran:
        // pause-spin to 2us, yield-spin to spin_ns, futex park beyond —
        // no extra clock reads (both endpoints already existed)
        const int64_t spin_end = spin_ns < 2000 ? spin_ns : 2000;
        const int64_t spin = waited < spin_end ? waited : spin_end;
        const int64_t capped = waited < spin_ns ? waited : spin_ns;
        const int64_t yield = capped > spin_end ? capped - spin_end : 0;
        const int64_t park = waited > spin_ns ? waited - spin_ns : 0;
        tr_spin_ns.fetch_add(spin, std::memory_order_relaxed);
        tr_yield_ns.fetch_add(yield, std::memory_order_relaxed);
        tr_park_ns.fetch_add(park, std::memory_order_relaxed);
        tr_wakes.fetch_add(1, std::memory_order_relaxed);
        tr_emit(tid, t_park, spin, TEV_SPIN, 0);
        if (yield > 0) tr_emit(tid, t_park + spin_end, yield, TEV_YIELD, 0);
        if (park > 0) tr_emit(tid, t_park + spin_ns, park, TEV_PARK, 0);
      }
      run_units(tid);
      busy_ns[tid].fetch_add(now_ns() - t_work, std::memory_order_relaxed);
      if (active_workers.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        done_seq.store(seen, std::memory_order_release);
        futex_wake_u32(&done_seq, 1);
      }
    }
  }

  // Publish the current job/units to the workers; the caller then helps
  // drain the unit list itself (it would otherwise just spin) and waits
  // on the done futex.
  void publish_job() {
    next.store(0, std::memory_order_relaxed);
    if (tracing())  // per-slot unit counts for the imbalance read below
      std::fill(units_call.begin(), units_call.end(), 0);
    active_workers.store((int)workers.size(), std::memory_order_relaxed);
    job_seq.fetch_add(1, std::memory_order_seq_cst);
    if (parked.load(std::memory_order_seq_cst) > 0)
      futex_wake_u32(&job_seq, INT_MAX);
  }

  void wait_done() {
    const uint32_t target = job_seq.load(std::memory_order_relaxed);
    const int64_t t_spin = now_ns();
    while (done_seq.load(std::memory_order_acquire) != target) {
      const int64_t waited = now_ns() - t_spin;
      if (waited < spin_ns) {
        // pause-spin briefly, then yield-spin: the unit list is already
        // drained when the caller gets here, so the tail worker needs
        // the CPU more than this thread needs the lowest-latency wake
        if (waited < 2000) cpu_pause();
        else std::this_thread::yield();
        continue;
      }
      futex_wait_u32(&done_seq, target - 1);
    }
  }

  int lowest_rc() const {
    for (int r : rep_rc)
      if (r != 0) return r;  // lowest replica index wins (deterministic)
    return 0;
  }

  int serve_replica(int r, Interp* it) {
    const Job& j = job;
    const int n = it->n_lanes, s = it->num_stacks;
    int32_t* acc = j.acc + (size_t)r * n;
    int32_t* bak = j.bak + (size_t)r * n;
    int32_t* pc = j.pc + (size_t)r * n;
    int32_t* port_val = j.port_val + (size_t)r * n * kPorts;
    uint8_t* port_full = j.port_full + (size_t)r * n * kPorts;
    int32_t* hold_val = j.hold_val + (size_t)r * n;
    uint8_t* holding = j.holding + (size_t)r * n;
    int32_t* stack_mem = j.stack_mem + (size_t)r * s * it->stack_cap;
    int32_t* stack_top = j.stack_top + (size_t)r * s;
    int32_t* in_buf = j.in_buf + (size_t)r * it->in_cap;
    int32_t* out_buf = j.out_buf + (size_t)r * it->out_cap;
    int32_t* counters = j.counters + (size_t)r * 5;
    int32_t* retired = j.retired + (size_t)r * n;
    int32_t* acc_hi = j.acc_hi + (size_t)r * n;
    int32_t* bak_hi = j.bak_hi + (size_t)r * n;
    if (write_state(it, acc, bak, pc, port_val, port_full, hold_val, holding,
                    stack_mem, stack_top, in_buf, out_buf, counters, retired,
                    acc_hi, bak_hi) != 0)
      return -1;
    if (j.feeding) {
      int count = j.feed_counts[r];
      if (count > 0 &&
          interp_feed(it, j.feed_vals + (size_t)r * it->in_cap, count) != count)
        return -2;  // caller cut to free space; a shortfall is a bug
    }
    interp_run(it, j.ticks);
    if (j.feeding) {
      int32_t* row = j.packed + (size_t)r * (4 + it->out_cap);
      row[0] = it->in_rd;
      row[1] = it->in_wr;
      row[2] = it->out_rd;
      row[3] = it->out_wr;
      std::memcpy(row + 4, it->out_buf.data(), (size_t)it->out_cap * 4);
      it->out_rd = it->out_wr;  // drain AFTER the snapshot (device parity)
    } else {
      int32_t* row = j.packed + (size_t)r * 4;
      row[0] = it->in_rd;
      row[1] = it->in_wr;
      row[2] = it->out_rd;
      row[3] = it->out_wr;  // idle: counters only, ring untouched
    }
    read_state(it, acc, bak, pc, port_val, port_full, hold_val, holding,
               stack_mem, stack_top, out_buf, counters, retired, acc_hi,
               bak_hi);
    std::memcpy(in_buf, it->in_buf.data(), (size_t)it->in_cap * 4);
    return 0;
  }

  // Resident scalar serve: replicas[r] IS the state — feed/run/pack with
  // no state round trip (the Interp analog of group_serve_resident).
  int serve_replica_resident(int r) {
    Interp* it = replicas[r];
    const Job& j = job;
    if (j.feeding &&
        j.feed_counts[r] > it->in_cap - (it->in_wr - it->in_rd))
      return -2;
    int64_t retired0 = 0;
    if (j.progress != nullptr)
      for (int32_t v : it->retired) retired0 += v;
    if (j.feeding) {
      const int count = j.feed_counts[r];
      if (count > 0)
        interp_feed(it, j.feed_vals + (size_t)r * it->in_cap, count);
    }
    interp_run(it, j.ticks);
    if (j.feeding) {
      int32_t* row = j.packed + (size_t)r * (4 + it->out_cap);
      row[0] = it->in_rd;
      row[1] = it->in_wr;
      row[2] = it->out_rd;
      row[3] = it->out_wr;
      std::memcpy(row + 4, it->out_buf.data(), (size_t)it->out_cap * 4);
      it->out_rd = it->out_wr;  // drain AFTER the snapshot
    } else {
      int32_t* row = j.packed + (size_t)r * 4;
      row[0] = it->in_rd;
      row[1] = it->in_wr;
      row[2] = it->out_rd;
      row[3] = it->out_wr;
    }
    if (j.progress != nullptr) {
      int64_t s = 0;
      for (int32_t v : it->retired) s += v;
      j.progress[r] = (uint8_t)(s != retired0);
    }
    return 0;
  }

  // A resident replica OUTSIDE the active set: packed row only (current
  // counters, plus the drained-on-serve contract for an undrained ring
  // on a feeding pass) — state otherwise untouched, ticks not advanced.
  void pack_skipped(int rep) {
    const Job& j = job;
    const int ocap = replicas[0]->out_cap;
    uint8_t* dirty =
        (j.feeding ? pack_dirty_serve : pack_dirty_idle).data();
    // Elision fast path: the caller is reusing the previous call's packed
    // buffer and this quiescent replica's row in it is still current (and
    // output-free for the serve kind) — skip the counter reads AND the
    // row write entirely.  This is the B-proportional light-fill cost of
    // sparse-fill serving.
    if (j.reuse != 0 && !dirty[rep]) {
      ++call_elided;
      if (j.progress != nullptr) j.progress[rep] = 0;
      return;
    }
    int32_t c[4];
    const int32_t* out_src = nullptr;
    if (rep < group_cover) {
      Group& g = *res_groups[rep / kGroupW];
      const int r = rep % kGroupW;
      c[0] = g.in_rd[r];
      c[1] = g.in_wr[r];
      c[2] = g.out_rd[r];
      c[3] = g.out_wr[r];
      if (j.feeding && c[3] > c[2]) {
        out_src = &g.out_buf[(size_t)r * ocap];
        g.out_rd[r] = c[3];
      }
    } else {
      Interp* it = replicas[rep];
      c[0] = it->in_rd;
      c[1] = it->in_wr;
      c[2] = it->out_rd;
      c[3] = it->out_wr;
      if (j.feeding && c[3] > c[2]) {
        out_src = it->out_buf.data();
        it->out_rd = c[3];
      }
    }
    int32_t* row = j.packed + (size_t)rep * (j.feeding ? 4 + ocap : 4);
    row[0] = c[0];
    row[1] = c[1];
    row[2] = c[2];
    row[3] = c[3];
    if (out_src != nullptr) {
      std::memcpy(row + 4, out_src, (size_t)ocap * 4);
      // The row carries a pre-drain snapshot the caller consumes once;
      // replaying it from cache would double-serve the outputs, and the
      // drain advanced out_rd under the OTHER kind's cached row too.
      pack_dirty_serve[rep] = 1;
      pack_dirty_idle[rep] = 1;
    } else {
      dirty[rep] = 0;
    }
    ++call_skip_packed;
    if (j.progress != nullptr) j.progress[rep] = 0;
  }

  // The caller's whole skipped-row pass.  Under a reused buffer the
  // sparse steady state is a long clean run, and a clean row needs
  // NOTHING — its cached packed row is current and its progress entry
  // is already 0 (every clean row's last writer wrote 0; an active unit
  // re-dirties the row before it can record progress) — so the pass
  // degenerates to a dirty-byte scan with zero per-row stores.
  void pack_skipped_all() {
    if (job.reuse != 0) {
      const uint8_t* dirty =
          (job.feeding ? pack_dirty_serve : pack_dirty_idle).data();
      int64_t clean = 0;
      for (const auto& run : res_skipped) {
        int r = run.first;
        const int end = run.first + run.second;
        while (r < end) {
          const uint8_t* hit =
              (const uint8_t*)std::memchr(dirty + r, 1, (size_t)(end - r));
          if (hit == nullptr) {
            clean += end - r;
            break;
          }
          const int d = (int)(hit - dirty);
          clean += d - r;
          pack_skipped(d);
          r = d + 1;
        }
      }
      call_elided += clean;
      return;
    }
    for (const auto& run : res_skipped)
      for (int r = run.first; r < run.first + run.second; ++r)
        pack_skipped(r);
  }

  // Unit-size policy (the adaptive half of the dispenser): ~4 units per
  // thread bounds dispenser traffic AND the tail thread's wall at full
  // batch; small jobs degrade to count=1.
  int unit_chunk(int n_units) const {
    const int t = (int)workers.size();
    // 1-worker pools run every unit inline on the caller, so dispense
    // granularity buys nothing — one maximal unit (fewer loop + flight-
    // recorder emits per call; the r18 A/B measured per-unit emit cost
    // on exactly this path)
    if (t <= 1) return n_units < 1 ? 1 : n_units;
    if (n_units <= t) return 1;
    const int c = n_units / (t * 4);
    return c < 1 ? 1 : c;
  }

  // Build the per-job work list: full kGroupW-aligned blocks of active
  // replicas become group units when the SIMD path is armed; everything
  // else (batch remainder, partial groups under partial fill, the whole
  // pool under MISAKA_SIMD=0) goes per-replica through the scalar Interp.
  void build_units() {
    units.clear();
    res_units_valid = false;  // the resident cache's list is clobbered
    const int B = (int)replicas.size();
    const bool grouped = group_fn != nullptr;
    if (job.active == nullptr) {
      const int ng = grouped ? B / kGroupW : 0;
      const int gc = unit_chunk(ng);
      for (int g = 0; g < ng; g += gc)
        units.push_back({U_GROUP, g, ng - g < gc ? ng - g : gc});
      const int r0 = ng * kGroupW;
      const int rc = unit_chunk(B - r0);
      for (int r = r0; r < B; r += rc)
        units.push_back({U_SCALAR, r, B - r < rc ? B - r : rc});
      return;
    }
    int i = 0;
    while (i < job.n_active) {
      const int r = job.active[i];
      const int g = r / kGroupW;
      // strictly-increasing active + matching endpoints == the whole
      // aligned block is present
      if (grouped && r == g * kGroupW && i + kGroupW <= job.n_active &&
          job.active[i + kGroupW - 1] == g * kGroupW + kGroupW - 1) {
        units.push_back({U_GROUP, g, 1});
        i += kGroupW;
      } else {
        units.push_back({U_SCALAR, r, 1});
        ++i;
      }
    }
  }

  // The resident work list: every resident group with at least one
  // active replica becomes a unit (masked when partially active); fully
  // skipped replicas go on res_skipped for the caller to pack while the
  // workers tick.
  //
  // The build is pure in (B, active list), and steady sparse serving
  // repeats the same hot set call after call — so the previous call's
  // units/res_skipped/res_mask are reused verbatim when the list
  // matches (the r21 elision profile showed the O(B) mask + skip-list
  // rebuild costing as much as the pack pass it feeds).  Single
  // serializing caller; build_units() invalidates on a stateless pass.
  std::vector<int32_t> res_units_key;
  bool res_units_valid = false, res_units_full = false;

  void build_units_resident() {
    const bool full = job.active == nullptr;
    if (res_units_valid && full == res_units_full &&
        (full || ((int)res_units_key.size() == job.n_active &&
                  std::memcmp(res_units_key.data(), job.active,
                              (size_t)job.n_active * sizeof(int32_t)) == 0)))
      return;
    units.clear();
    res_skipped.clear();
    res_units_valid = true;
    res_units_full = full;
    if (full) res_units_key.clear();
    else res_units_key.assign(job.active, job.active + job.n_active);
    const int B = (int)replicas.size();
    const int ng = group_cover / kGroupW;
    if (job.active == nullptr) {
      const int gc = unit_chunk(ng);
      for (int g = 0; g < ng; g += gc)
        units.push_back({U_RES_GROUP, g, ng - g < gc ? ng - g : gc});
      const int rc = unit_chunk(B - group_cover);
      for (int r = group_cover; r < B; r += rc)
        units.push_back({U_RES_SCALAR, r, B - r < rc ? B - r : rc});
      return;
    }
    res_mask.assign(B, 0);
    for (int i = 0; i < job.n_active; ++i) res_mask[job.active[i]] = 1;
    auto skip = [this](int rep0, int count) {
      if (!res_skipped.empty() &&
          res_skipped.back().first + res_skipped.back().second == rep0)
        res_skipped.back().second += count;  // extend the adjacent run
      else
        res_skipped.push_back({rep0, count});
    };
    for (int g = 0; g < ng; ++g) {
      int cnt = 0;
      for (int r = 0; r < kGroupW; ++r) cnt += res_mask[g * kGroupW + r];
      if (cnt == kGroupW) {
        units.push_back({U_RES_GROUP, g, 1});
      } else if (cnt > 0) {
        units.push_back({U_RES_MASKED, g, 1});
      } else {
        skip(g * kGroupW, kGroupW);
      }
    }
    for (int r = group_cover; r < B; ++r) {
      if (res_mask[r]) units.push_back({U_RES_SCALAR, r, 1});
      else skip(r, 1);
    }
  }

  // Dispenser-wait accounting around wait_done (publish paths only): the
  // caller has already helped drain the unit list, so this wait IS the
  // straggler tail — the figure the r17 "no ~180us barrier" claim needs
  // measured, not inferred.  The per-slot unit counts it reads were
  // written before each worker's acq_rel countdown, so the done_seq
  // acquire in wait_done orders them.
  void wait_done_traced() {
    const int64_t t_wait = now_ns();
    wait_done();
    const int64_t w = now_ns() - t_wait;
    tr_dispatch_calls.fetch_add(1, std::memory_order_relaxed);
    tr_dispatch_wait_ns.fetch_add(w, std::memory_order_relaxed);
    tr_last_wait_ns.store(w, std::memory_order_relaxed);
    int32_t mx = 0, mn = INT32_MAX;
    for (size_t t = 0; t < workers.size(); ++t) {
      mx = units_call[t] > mx ? units_call[t] : mx;
      mn = units_call[t] < mn ? units_call[t] : mn;
    }
    tr_last_imbalance.store(mx - mn, std::memory_order_relaxed);
  }

  int run_job() {
    const int n = job.active ? job.n_active : (int)replicas.size();
    const int64_t t_call = tracing() ? now_ns() : 0;
    const int64_t fflag = job.feeding ? 1 : 0;
    // Serial fast path: a small pass (the partial-fill serving case — a
    // few coalesced slots out of thousands) runs on the CALLING thread;
    // even the flat dispenser's wake round trip dwarfs the work itself
    // below a handful of replicas.  (n <= 4 < kGroupW, so this path
    // never sees a group unit.)
    if (n <= 4) {
      const int64_t t_work = now_ns();
      int rc = 0;
      const int slot = (int)workers.size();  // the caller's scratch slot
      for (int i = 0; i < n; ++i) {
        const int rep = job.active ? job.active[i] : i;
        const int r = serve_replica(rep, scratch_interps[slot]);
        if (r != 0 && rc == 0) rc = r;  // lowest index first by iteration
      }
      serial_busy_ns.fetch_add(now_ns() - t_work, std::memory_order_relaxed);
      return finish_serve(rc, t_call, n, fflag | 4);
    }
    build_units();
    rep_rc.assign(replicas.size(), 0);
    // A 1-worker pool gains nothing from the handoff (the caller IS an
    // executor): run the whole list inline — zero dispenser cost, and on
    // a 1-core box no spin contention against the lone worker.
    if (workers.size() <= 1 || units.size() <= 1) {
      const int64_t t_work = now_ns();
      for (const Unit& u : units) serve_unit(u, (int)workers.size());
      serial_busy_ns.fetch_add(now_ns() - t_work, std::memory_order_relaxed);
      return finish_serve(lowest_rc(), t_call, n, fflag | 4);
    }
    publish_job();
    const int64_t t_help = now_ns();
    run_units((int)workers.size());
    serial_busy_ns.fetch_add(now_ns() - t_help, std::memory_order_relaxed);
    if (t_call != 0) wait_done_traced();
    else wait_done();
    return finish_serve(lowest_rc(), t_call, n, fflag);
  }

  // The resident twin of run_job: no import/export anywhere — the units
  // tick the resident store in place, the caller packs the skipped rows
  // (work it would otherwise spend spinning on the done futex).
  int run_resident_job() {
    const int n = job.active ? job.n_active : (int)replicas.size();
    const int64_t t_call = tracing() ? now_ns() : 0;
    const int64_t fflag = (job.feeding ? 1 : 0) | 2;  // resident
    if (!elide_on) job.reuse = 0;
    if (job.reuse == 0 && !pack_dirty_serve.empty()) {
      // Fresh caller buffer for this kind: every row must be written once
      // before its cached copy can be trusted.
      std::memset((job.feeding ? pack_dirty_serve : pack_dirty_idle).data(),
                  1, pack_dirty_serve.size());
    }
    call_elided = 0;
    call_skip_packed = 0;
    build_units_resident();
    rep_rc.assign(replicas.size(), 0);
    const int caller = (int)workers.size();
    if (n <= 4 || units.size() <= 1 || workers.size() <= 1) {
      const int64_t t_work = now_ns();
      for (const Unit& u : units) serve_unit(u, caller);
      pack_skipped_all();
      serial_busy_ns.fetch_add(now_ns() - t_work, std::memory_order_relaxed);
      flush_elision();
      return finish_serve(lowest_rc(), t_call, n, fflag | 4);
    }
    publish_job();
    const int64_t t_help = now_ns();
    pack_skipped_all();
    run_units(caller);
    serial_busy_ns.fetch_add(now_ns() - t_help, std::memory_order_relaxed);
    if (t_call != 0) wait_done_traced();
    else wait_done();
    flush_elision();
    return finish_serve(lowest_rc(), t_call, n, fflag);
  }

  void flush_elision() {
    if (call_elided)
      elided_rows.fetch_add(call_elided, std::memory_order_relaxed);
    if (call_skip_packed)
      skip_packed_rows.fetch_add(call_skip_packed, std::memory_order_relaxed);
  }

  // Arm residency from the job's batch-major state arrays.  Per-group
  // validate-then-load, per-remainder write_state (which validates before
  // touching): `resident` flips true only after EVERY replica loaded, so
  // a failed import leaves residency observably disarmed and the arrays
  // authoritative (partially-loaded storage is dormant).
  int import_state() {
    const int B = (int)replicas.size();
    resident = false;
    mark_all_dirty();  // cached pack rows describe the replaced state
    if (resident_fn != nullptr && group_cover > 0 && res_groups.empty()) {
      const int ng = group_cover / kGroupW;
      res_groups.reserve(ng);
      for (int g = 0; g < ng; ++g) {
        res_groups.push_back(new Group(
            replicas[0]->code.data(), replicas[0]->prog_len.data(),
            replicas[0]->n_lanes, replicas[0]->max_len,
            replicas[0]->num_stacks, replicas[0]->stack_cap,
            replicas[0]->in_cap, replicas[0]->out_cap));
        apply_jit(res_groups.back());
      }
    }
    for (int g = 0; g < group_cover / kGroupW; ++g)
      if (group_import_checked(*res_groups[g], job, g * kGroupW) != 0)
        return -1;
    for (int r = group_cover; r < B; ++r)
      if (write_replica(r) != 0) return -1;
    resident = true;
    return 0;
  }

  // Export the resident state into the job's batch-major arrays —
  // non-destructive (rings undrained, residency stays armed).
  int export_state() {
    if (!resident) return -1;
    for (int g = 0; g < group_cover / kGroupW; ++g)
      group_export_plain(*res_groups[g], job, g * kGroupW);
    for (int r = group_cover; r < (int)replicas.size(); ++r)
      read_replica(r);
    return 0;
  }

  int write_replica(int r) {
    Interp* it = replicas[r];
    const Job& j = job;
    const int n = it->n_lanes, s = it->num_stacks;
    return write_state(
        it, j.acc + (size_t)r * n, j.bak + (size_t)r * n,
        j.pc + (size_t)r * n, j.port_val + (size_t)r * n * kPorts,
        j.port_full + (size_t)r * n * kPorts, j.hold_val + (size_t)r * n,
        j.holding + (size_t)r * n, j.stack_mem + (size_t)r * s * it->stack_cap,
        j.stack_top + (size_t)r * s, j.in_buf + (size_t)r * it->in_cap,
        j.out_buf + (size_t)r * it->out_cap, j.counters + (size_t)r * 5,
        j.retired + (size_t)r * n, j.acc_hi + (size_t)r * n,
        j.bak_hi + (size_t)r * n);
  }

  void read_replica(int r) {
    Interp* it = replicas[r];
    const Job& j = job;
    const int n = it->n_lanes, s = it->num_stacks;
    read_state(
        it, j.acc + (size_t)r * n, j.bak + (size_t)r * n,
        j.pc + (size_t)r * n, j.port_val + (size_t)r * n * kPorts,
        j.port_full + (size_t)r * n * kPorts, j.hold_val + (size_t)r * n,
        j.holding + (size_t)r * n, j.stack_mem + (size_t)r * s * it->stack_cap,
        j.stack_top + (size_t)r * s, j.out_buf + (size_t)r * it->out_cap,
        j.counters + (size_t)r * 5, j.retired + (size_t)r * n,
        j.acc_hi + (size_t)r * n, j.bak_hi + (size_t)r * n);
    std::memcpy(j.in_buf + (size_t)r * it->in_cap, it->in_buf.data(),
                (size_t)it->in_cap * 4);
  }
};

}  // namespace

extern "C" {

// Source-identity tag scanned from the .so bytes by utils/nativelib.py to
// detect a binary built from different source (mtime comparison cannot —
// a fresh checkout gives every file the same timestamp).  The build injects
// -DMISAKA_SRC_HASH=<sha256[:16] of this file>.
#ifndef MISAKA_SRC_HASH
#define MISAKA_SRC_HASH "unbuilt"
#endif
__attribute__((used)) const char misaka_src_hash_tag[] =
    "MISAKA-SRC-HASH:" MISAKA_SRC_HASH;

void* misaka_interp_create(const int32_t* code, const int32_t* prog_len,
                           int n_lanes, int max_len, int num_stacks,
                           int stack_cap, int in_cap, int out_cap) {
  return create_interp(code, prog_len, n_lanes, max_len, num_stacks,
                       stack_cap, in_cap, out_cap);
}

void misaka_interp_destroy(void* h) { delete (Interp*)h; }

int misaka_interp_feed(void* h, const int32_t* values, int count) {
  return interp_feed((Interp*)h, values, count);
}

void misaka_interp_run(void* h, int ticks) { interp_run((Interp*)h, ticks); }

// Set ring counters directly (checkpoint restore; rebase soak tests).
// Returns 0 on success, -1 (state unchanged) when the pair violates the
// ring invariants 0 <= rd <= wr, wr - rd <= cap: a hostile rd (negative
// `%` in C++ rounds toward zero) or over-occupied ring would index out of
// the buffers on the next run/drain.
int misaka_interp_seed_counters(void* h, int32_t in_rd, int32_t in_wr,
                                int32_t out_rd, int32_t out_wr) {
  auto* it = (Interp*)h;
  if (in_rd < 0 || in_wr < in_rd || in_wr - in_rd > it->in_cap ||
      out_rd < 0 || out_wr < out_rd || out_wr - out_rd > it->out_cap)
    return -1;
  it->in_rd = in_rd;
  it->in_wr = in_wr;
  it->out_rd = out_rd;
  it->out_wr = out_wr;
  return 0;
}

int misaka_interp_drain(void* h, int32_t* out, int max_out) {
  auto* it = (Interp*)h;
  int got = 0;
  while (it->out_rd < it->out_wr && got < max_out) {
    out[got++] = it->out_buf[it->out_rd % it->out_cap];
    it->out_rd += 1;
  }
  return got;
}

// The input ring's contents (misaka_interp_read exposes everything else;
// full-state export for the serving engine needs the undelivered inputs too).
void misaka_interp_read_in(void* h, int32_t* in_buf) {
  auto* it = (Interp*)h;
  std::memcpy(in_buf, it->in_buf.data(), (size_t)it->in_cap * 4);
}

// The serve_chunk packed row ([in_rd, in_wr, out_rd, out_wr, out_buf...])
// straight off the interpreter, optionally draining the output ring after
// the snapshot — the resident-state fast path of the unbatched serving
// engine (core/native_serve.NativeServe), which no longer exports the
// whole state per chunk just to read four counters and the ring.
void misaka_interp_pack(void* h, int32_t* row, int drain) {
  auto* it = (Interp*)h;
  row[0] = it->in_rd;
  row[1] = it->in_wr;
  row[2] = it->out_rd;
  row[3] = it->out_wr;
  if (drain != 0) {
    std::memcpy(row + 4, it->out_buf.data(), (size_t)it->out_cap * 4);
    it->out_rd = it->out_wr;  // drain AFTER the snapshot (device parity)
  }
}

// Bulk state write — the inverse of misaka_interp_read (+ in_buf), used by
// the native serving engine to import a NetworkState pytree before a chunk
// (runtime/master.py engine="native") and by checkpoint restore.  Validates
// EVERYTHING it indexes with before touching the interpreter (pc within the
// lane's program, stack tops within capacity, ring invariants); returns 0
// on success, -1 with the state unchanged on any violation.
int misaka_interp_write(void* h, const int32_t* acc, const int32_t* bak,
                        const int32_t* pc, const int32_t* port_val,
                        const uint8_t* port_full, const int32_t* hold_val,
                        const uint8_t* holding, const int32_t* stack_mem,
                        const int32_t* stack_top, const int32_t* in_buf,
                        const int32_t* out_buf, const int32_t* counters /*[5]*/,
                        const int32_t* retired, const int32_t* acc_hi,
                        const int32_t* bak_hi) {
  return write_state((Interp*)h, acc, bak, pc, port_val, port_full, hold_val,
                     holding, stack_mem, stack_top, in_buf, out_buf, counters,
                     retired, acc_hi, bak_hi);
}

// Bulk state read-back for differential comparison.  stack_mem is
// [num_stacks][stack_cap], zero-padded above each stack's top.
void misaka_interp_read(void* h, int32_t* acc, int32_t* bak, int32_t* pc,
                        int32_t* port_val, uint8_t* port_full,
                        int32_t* hold_val, uint8_t* holding,
                        int32_t* stack_mem, int32_t* stack_top,
                        int32_t* out_buf, int32_t* counters /*[5]*/,
                        int32_t* retired, int32_t* acc_hi, int32_t* bak_hi) {
  read_state((Interp*)h, acc, bak, pc, port_val, port_full, hold_val, holding,
             stack_mem, stack_top, out_buf, counters, retired, acc_hi, bak_hi);
}

// --- the multi-threaded serving pool (see struct Pool above) ---------------

// Create `n_replicas` independent interpreter instances for one network,
// served by `n_threads` persistent worker threads (clamped to [1, replicas]).
// Null on invalid tables — the same validation as misaka_interp_create, run
// once per replica.
void* misaka_pool_create(const int32_t* code, const int32_t* prog_len,
                         int n_lanes, int max_len, int num_stacks,
                         int stack_cap, int in_cap, int out_cap,
                         int n_replicas, int n_threads) {
  if (n_replicas <= 0) return nullptr;
  auto* p = new Pool();
  p->replicas.reserve(n_replicas);
  for (int r = 0; r < n_replicas; ++r) {
    Interp* it = create_interp(code, prog_len, n_lanes, max_len, num_stacks,
                               stack_cap, in_cap, out_cap);
    if (it == nullptr) {
      delete p;  // joins zero workers, deletes the replicas built so far
      return nullptr;
    }
    p->replicas.push_back(it);
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_replicas) n_threads = n_replicas;
  p->busy_ns = std::vector<std::atomic<int64_t>>(n_threads);
  p->idle_ns = std::vector<std::atomic<int64_t>>(n_threads);
  const char* spin = std::getenv("MISAKA_POOL_SPIN_US");
  if (spin != nullptr && *spin != '\0')
    p->spin_ns = (int64_t)std::atol(spin) * 1000;
  // Per-thread (+ caller) scratch interpreters for the stateless scalar
  // path: the per-replica interpreters are the RESIDENT store, which a
  // concurrent stateless call must never clobber.
  p->scratch_interps.reserve(n_threads + 1);
  for (int t = 0; t < n_threads + 1; ++t) {
    Interp* it = create_interp(code, prog_len, n_lanes, max_len, num_stacks,
                               stack_cap, in_cap, out_cap);
    if (it == nullptr) {  // cannot happen (replicas validated) — be safe
      delete p;
      return nullptr;
    }
    p->scratch_interps.push_back(it);
  }
  // SIMD group path: armed when the kill switch allows it and the batch
  // has at least one full group; specialized tick functions additionally
  // require the runtime tables to MATCH the baked ones (a mismatched
  // specialized .so degrades to the generic group path, never corrupts).
  p->simd_mode = simd_mode_from_env();
  if (p->simd_mode != SIMD_OFF && n_replicas >= kGroupW) {
#ifdef MISAKA_SPEC
    p->specialized = spec_matches(code, prog_len, n_lanes, max_len,
                                  p->replicas[0]->num_stacks, stack_cap,
                                  in_cap, out_cap);
#endif
    p->group_fn = pick_group_fn(p->simd_mode, p->specialized);
    p->scratch_groups.reserve(n_threads + 1);
    for (int t = 0; t < n_threads + 1; ++t)
      p->scratch_groups.push_back(new Group(
          p->replicas[0]->code.data(), p->replicas[0]->prog_len.data(),
          n_lanes, max_len, p->replicas[0]->num_stacks, stack_cap, in_cap,
          out_cap));
    p->group_cover = (n_replicas / kGroupW) * kGroupW;
  } else {
    p->simd_mode = SIMD_OFF;
  }
  // the resident tick variant (group range) — scalar-only pools keep
  // resident state in the per-replica interpreters instead
  p->resident_fn =
      p->group_fn != nullptr ? pick_resident_fn(p->simd_mode, p->specialized)
                             : nullptr;
  // pack-row elision dirty ledger (everything dirty until first written)
  const char* el = std::getenv("MISAKA_PACK_ELIDE");
  p->elide_on = el == nullptr ||
                (std::strcmp(el, "0") != 0 && std::strcmp(el, "off") != 0);
  p->pack_dirty_serve.assign(n_replicas, 1);
  p->pack_dirty_idle.assign(n_replicas, 1);
  // Flight recorder (r18): rings allocated BEFORE the workers exist so a
  // worker never observes a half-built recorder.  MISAKA_NATIVE_TRACE=0
  // skips the allocation entirely (trace_set then has nothing to arm).
  p->units_call.assign(n_threads + 1, 0);
  const char* te = std::getenv("MISAKA_NATIVE_TRACE");
  if (te == nullptr ||
      (std::strcmp(te, "0") != 0 && std::strcmp(te, "off") != 0)) {
    int cap = 2048;
    const char* tc = std::getenv("MISAKA_NATIVE_TRACE_RING");
    if (tc != nullptr && *tc != '\0') cap = std::atoi(tc);
    if (cap < 64) cap = 64;
    if (cap > 65536) cap = 65536;
    p->trace_cap = cap;
    p->trace_buf = std::vector<std::atomic<int64_t>>(
        (size_t)(n_threads + 1) * cap * kTraceRecWords);
    p->trace_cur = std::vector<std::atomic<uint64_t>>(n_threads + 1);
    p->trace_built = true;
    p->trace_armed.store(1, std::memory_order_relaxed);
  }
  p->workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back([p, t] { p->worker_main(t); });
  return p;
}

// SIMD/specialization introspection for the metrics plane: out[0] = group
// width (kGroupW when the group path is armed, 0 when the pool runs the
// scalar per-replica path), out[1] = 1 when the AVX2 instantiation is
// selected (0 = the generic fallback from the same template), out[2] = 1
// when the pool executes per-program specialized tick functions, out[3] =
// 1 when the copy-and-patch JIT fragment tables are armed.
void misaka_pool_simd_info(void* h, int32_t* out /*[4]*/) {
  auto* p = (Pool*)h;
  out[0] = p->simd_mode == SIMD_OFF ? 0 : kGroupW;
  out[1] = p->simd_mode == SIMD_AVX2 ? 1 : 0;
  out[2] = p->specialized ? 1 : 0;
  out[3] = p->jit_armed ? 1 : 0;
}

// Arm the copy-and-patch JIT: tab1/tab2 are flat [n_lanes * max_len]
// tables of spliced fragment entry points (pass 1 / pass 2) pointing into
// an executable buffer the CALLER owns and must keep alive until disarm
// or pool destruction.  Caller contract: only between serve calls (same
// as import/discard).  Returns 0 on success; any nonzero rc means the
// pool is unchanged and the caller falls back one rung: -1 ABI version
// mismatch (stencils.cpp and this file drifted), -2 no group path armed
// (scalar pools have nothing to hook), -3 table shape mismatch, -4 null
// tables or a null fragment entry.
int misaka_pool_jit_arm(void* h, const void* const* tab1,
                        const void* const* tab2, int n_lanes, int max_len,
                        int abi) {
  auto* p = (Pool*)h;
  if (abi != MISAKA_JIT_ABI) return -1;
  if (p->group_fn == nullptr) return -2;
  Interp* it = p->replicas[0];
  if (n_lanes != it->n_lanes || max_len != it->max_len) return -3;
  if (tab1 == nullptr || tab2 == nullptr) return -4;
  const size_t n = (size_t)n_lanes * max_len;
  for (size_t i = 0; i < n; ++i)
    if (tab1[i] == nullptr || tab2[i] == nullptr) return -4;
  p->jit_tab1.resize(n);
  p->jit_tab2.resize(n);
  for (size_t i = 0; i < n; ++i) {
    p->jit_tab1[i] = (MisakaJitFn)tab1[i];
    p->jit_tab2[i] = (MisakaJitFn)tab2[i];
  }
  p->jit_armed = true;
  for (Group* g : p->scratch_groups) p->apply_jit(g);
  for (Group* g : p->res_groups) p->apply_jit(g);
  return 0;
}

// Disarm the JIT (the caller may then release the executable buffer).
void misaka_pool_jit_disarm(void* h) {
  auto* p = (Pool*)h;
  p->jit_armed = false;
  for (Group* g : p->scratch_groups) p->apply_jit(g);
  for (Group* g : p->res_groups) p->apply_jit(g);
  p->jit_tab1.clear();
  p->jit_tab2.clear();
}

// The specialization content key baked into this build ("" = the generic
// shipped library).  core/specialize.py keys its on-disk cache on this.
const char* misaka_spec_key(void) {
#ifdef MISAKA_SPEC
  return spec::key;
#else
  return "";
#endif
}

void misaka_pool_destroy(void* h) { delete (Pool*)h; }

int misaka_pool_threads(void* h) { return (int)((Pool*)h)->workers.size(); }

// Pool-level busy/idle nanosecond counters (usage accounting): out[0] =
// worker busy ns summed across threads, out[1] = worker idle ns (time
// parked on the work condition; a thread currently parked contributes its
// completed waits only), out[2] = serial-fast-path busy ns (small passes
// run on the calling thread), out[3] = quiescent pack rows ELIDED on
// resident serves (row write skipped: the caller's reused buffer was
// already current), out[4] = quiescent pack rows written.  Lock-free
// relaxed reads — a scrape must never stall a serving pass.
void misaka_pool_counters(void* h, int64_t* out /*[5]*/) {
  auto* p = (Pool*)h;
  int64_t busy = 0, idle = 0;
  for (auto& v : p->busy_ns) busy += v.load(std::memory_order_relaxed);
  for (auto& v : p->idle_ns) idle += v.load(std::memory_order_relaxed);
  out[0] = busy;
  out[1] = idle;
  out[2] = p->serial_busy_ns.load(std::memory_order_relaxed);
  out[3] = p->elided_rows.load(std::memory_order_relaxed);
  out[4] = p->skip_packed_rows.load(std::memory_order_relaxed);
}

// Per-thread busy/idle ns (the flamegraph's native annotation keys on the
// aggregate; the per-thread split is the skew diagnostic).  Fills up to
// `cap` entries of each array; returns the thread count.
int misaka_pool_thread_counters(void* h, int64_t* busy, int64_t* idle,
                                int cap) {
  auto* p = (Pool*)h;
  const int n = (int)p->workers.size();
  for (int t = 0; t < n && t < cap; ++t) {
    busy[t] = p->busy_ns[t].load(std::memory_order_relaxed);
    idle[t] = p->idle_ns[t].load(std::memory_order_relaxed);
  }
  return n;
}

// --- flight-recorder read API (r18) ----------------------------------------

// Recorder shape: out[0] = ring count (threads + 1; 0 = recorder not
// built), out[1] = records per ring, out[2] = armed, out[3] = total
// records dropped (overwritten before any reader saw them) across rings.
void misaka_pool_trace_info(void* h, int64_t* out /*[4]*/) {
  auto* p = (Pool*)h;
  out[0] = p->trace_built ? (int64_t)p->workers.size() + 1 : 0;
  out[1] = p->trace_cap;
  out[2] = p->tracing() ? 1 : 0;
  int64_t dropped = 0;
  for (auto& c : p->trace_cur) {
    const uint64_t cur = c.load(std::memory_order_relaxed);
    if (cur > (uint64_t)p->trace_cap) dropped += cur - p->trace_cap;
  }
  out[3] = dropped;
}

// Snapshot one ring WITHOUT stopping the pool: acquire the cursor, copy
// up to max_recs most-recent records (rows of [t0_ns, dur_ns, kind,
// arg], oldest first), then re-read the cursor and drop any prefix the
// writer lapped during the copy (those rows may be torn).  meta[0] =
// cursor after the copy, meta[1] = cumulative dropped-by-overwrite for
// this ring.  Returns the row count, or -1 on a bad ring index / absent
// recorder.  Ring `threads` is the calling thread's (serve lifecycle,
// caller-inline units, residency events).
int misaka_pool_trace_read(void* h, int ring, int64_t* out, int max_recs,
                           int64_t* meta /*[2]*/) {
  auto* p = (Pool*)h;
  if (!p->trace_built || ring < 0 || ring > (int)p->workers.size() ||
      max_recs < 0)
    return -1;
  const uint64_t cap = (uint64_t)p->trace_cap;
  std::atomic<uint64_t>& cur = p->trace_cur[ring];
  const uint64_t c1 = cur.load(std::memory_order_acquire);
  uint64_t lo = c1 > cap ? c1 - cap : 0;
  if (c1 - lo > (uint64_t)max_recs) lo = c1 - (uint64_t)max_recs;
  int n = 0;
  for (uint64_t i = lo; i < c1; ++i, ++n) {
    const std::atomic<int64_t>* r =
        &p->trace_buf[((size_t)ring * p->trace_cap + (size_t)(i % cap)) *
                      kTraceRecWords];
    for (int w = 0; w < kTraceRecWords; ++w)
      out[(size_t)n * kTraceRecWords + w] =
          r[w].load(std::memory_order_relaxed);
  }
  const uint64_t c2 = cur.load(std::memory_order_acquire);
  if (c2 >= cap) {
    // Rows at or below c2 - cap may be torn: every published write up
    // to c2 aliases slots of rows < c2 - cap, AND the writer may be
    // mid-write on record c2 itself (cursor not yet bumped), whose slot
    // is row c2 - cap's — so the oldest fully-safe row is c2 - cap + 1.
    const uint64_t valid_lo = c2 - cap + 1;
    if (valid_lo > lo) {
      uint64_t torn = valid_lo - lo;
      if (torn > (uint64_t)n) torn = (uint64_t)n;
      if (torn > 0) {
        std::memmove(out, out + torn * kTraceRecWords,
                     ((size_t)n - torn) * kTraceRecWords * sizeof(int64_t));
        n -= (int)torn;
      }
    }
  }
  meta[0] = (int64_t)c2;
  meta[1] = (int64_t)(c2 > cap ? c2 - cap : 0);
  return n;
}

// Cumulative recorder aggregates (relaxed reads, scrape-safe):
//   out[0..2]  dispenser wait ns by phase (spin / yield / park)
//   out[3]     worker wakes (jobs received)
//   out[4..6]  published serve calls / total caller dispatch-wait ns /
//              last call's dispatch-wait ns
//   out[7]     last published call's unit imbalance (max - min units
//              one worker drained)
//   out[8]     units drained on the CALLING thread (inline + help)
//   out[9..10] pool serve/idle calls / inline (never-published) calls
//   out[11]    records dropped by ring overwrite (all rings)
//   out[12..]  replicas ticked by [rung][shape] (kTraceRungs x
//              kTraceShapes; rung bit 2 = specialized, bit 3 = jit)
void misaka_pool_trace_stats(void* h, int64_t* out /*[76]*/) {
  auto* p = (Pool*)h;
  const auto rel = std::memory_order_relaxed;
  out[0] = p->tr_spin_ns.load(rel);
  out[1] = p->tr_yield_ns.load(rel);
  out[2] = p->tr_park_ns.load(rel);
  out[3] = p->tr_wakes.load(rel);
  out[4] = p->tr_dispatch_calls.load(rel);
  out[5] = p->tr_dispatch_wait_ns.load(rel);
  out[6] = p->tr_last_wait_ns.load(rel);
  out[7] = p->tr_last_imbalance.load(rel);
  out[8] = p->tr_caller_units.load(rel);
  out[9] = p->tr_serve_calls.load(rel);
  out[10] = p->tr_inline_calls.load(rel);
  int64_t dropped = 0;
  for (auto& c : p->trace_cur) {
    const uint64_t cur = c.load(rel);
    if (cur > (uint64_t)p->trace_cap) dropped += cur - p->trace_cap;
  }
  out[11] = dropped;
  for (int i = 0; i < kTraceRungs * kTraceShapes; ++i)
    out[12 + i] = p->tr_reps[i].load(rel);
}

// Arm/disarm a BUILT recorder at runtime (the overhead A/B's toggle —
// emit sites reduce to one relaxed flag load + branch when off).
// Returns the new state, or -1 when MISAKA_NATIVE_TRACE=0 skipped the
// ring allocation at create.
int misaka_pool_trace_set(void* h, int on) {
  auto* p = (Pool*)h;
  if (!p->trace_built) return -1;
  p->trace_armed.store(on ? 1 : 0, std::memory_order_relaxed);
  return on ? 1 : 0;
}

// One batched serve (feed_counts non-null) or idle (both feed pointers null)
// iteration across every replica.  State arrays are batch-major [B, ...];
// counters is [B, 5]; packed is [B, 4+out_cap] when feeding, [B, 4] idle.
// `active` (may be null = all) restricts the pass to a strictly-increasing
// list of replica indices — the partial-fill fast path; skipped replicas'
// state slices and packed rows are never touched (the caller prefills the
// rows).  Returns 0, or -1 (some replica's state slice failed import
// validation), -2 (a feed exceeded the ring's free space), or -3 (invalid
// active list); on error surviving replicas still round-tripped their
// slices unchanged-or-served, so the caller must treat the whole call as
// failed.
int misaka_pool_serve(void* h, int32_t* acc, int32_t* bak, int32_t* pc,
                      int32_t* port_val, uint8_t* port_full, int32_t* hold_val,
                      uint8_t* holding, int32_t* stack_mem, int32_t* stack_top,
                      int32_t* in_buf, int32_t* out_buf, int32_t* counters,
                      int32_t* retired, int32_t* acc_hi, int32_t* bak_hi,
                      const int32_t* feed_vals, const int32_t* feed_counts,
                      int ticks, const int32_t* active, int n_active,
                      int32_t* packed) {
  auto* p = (Pool*)h;
  if (active != nullptr) {
    if (n_active < 0 || n_active > (int)p->replicas.size()) return -3;
    for (int i = 0; i < n_active; ++i) {
      if (active[i] < 0 || active[i] >= (int)p->replicas.size()) return -3;
      if (i > 0 && active[i] <= active[i - 1]) return -3;  // dupes would race
    }
  }
  Pool::Job& j = p->job;
  j.acc = acc;
  j.bak = bak;
  j.pc = pc;
  j.port_val = port_val;
  j.port_full = port_full;
  j.hold_val = hold_val;
  j.holding = holding;
  j.stack_mem = stack_mem;
  j.stack_top = stack_top;
  j.in_buf = in_buf;
  j.out_buf = out_buf;
  j.counters = counters;
  j.retired = retired;
  j.acc_hi = acc_hi;
  j.bak_hi = bak_hi;
  j.feed_vals = feed_vals;
  j.feed_counts = feed_counts;
  j.ticks = ticks;
  j.feeding = feed_counts != nullptr;
  j.packed = packed;
  j.active = active;
  j.n_active = n_active;
  j.progress = nullptr;
  return p->run_job();
}

// --- resident-state serving (r17) ------------------------------------------
//
// misaka_pool_import arms residency: the batch-major arrays are validated
// and loaded into the pool's resident store (SoA groups + remainder
// interpreters), after which misaka_pool_serve_resident runs serve/idle
// passes with NO state round trip — the ~200us/call import/export floor
// at B=256 is simply gone.  misaka_pool_export writes the resident state
// back out (non-destructive; residency stays armed) for lifecycle paths
// — checkpoint, /load, /restore, autogrow, registry eviction — and
// misaka_pool_discard disarms without exporting (the caller replaced the
// state wholesale).  The caller (core/native_serve.NativeServePool) only
// takes the resident path while its Python-side identity cache proves
// nothing else touched the state.

int misaka_pool_import(void* h, const int32_t* acc, const int32_t* bak,
                       const int32_t* pc, const int32_t* port_val,
                       const uint8_t* port_full, const int32_t* hold_val,
                       const uint8_t* holding, const int32_t* stack_mem,
                       const int32_t* stack_top, const int32_t* in_buf,
                       const int32_t* out_buf, const int32_t* counters,
                       const int32_t* retired, const int32_t* acc_hi,
                       const int32_t* bak_hi) {
  auto* p = (Pool*)h;
  Pool::Job& j = p->job;
  j = Pool::Job{};
  j.acc = (int32_t*)acc;
  j.bak = (int32_t*)bak;
  j.pc = (int32_t*)pc;
  j.port_val = (int32_t*)port_val;
  j.port_full = (uint8_t*)port_full;
  j.hold_val = (int32_t*)hold_val;
  j.holding = (uint8_t*)holding;
  j.stack_mem = (int32_t*)stack_mem;
  j.stack_top = (int32_t*)stack_top;
  j.in_buf = (int32_t*)in_buf;
  j.out_buf = (int32_t*)out_buf;
  j.counters = (int32_t*)counters;
  j.retired = (int32_t*)retired;
  j.acc_hi = (int32_t*)acc_hi;
  j.bak_hi = (int32_t*)bak_hi;
  const int64_t t0 = p->tracing() ? now_ns() : 0;
  const int rc = p->import_state();
  if (t0 != 0)
    p->tr_emit((int)p->workers.size(), t0, now_ns() - t0, TEV_IMPORT,
               (int64_t)(uint32_t)p->replicas.size() |
                   ((int64_t)(rc != 0) << 32));
  return rc;
}

int misaka_pool_export(void* h, int32_t* acc, int32_t* bak, int32_t* pc,
                       int32_t* port_val, uint8_t* port_full,
                       int32_t* hold_val, uint8_t* holding,
                       int32_t* stack_mem, int32_t* stack_top,
                       int32_t* in_buf, int32_t* out_buf, int32_t* counters,
                       int32_t* retired, int32_t* acc_hi, int32_t* bak_hi) {
  auto* p = (Pool*)h;
  Pool::Job& j = p->job;
  j = Pool::Job{};
  j.acc = acc;
  j.bak = bak;
  j.pc = pc;
  j.port_val = port_val;
  j.port_full = port_full;
  j.hold_val = hold_val;
  j.holding = holding;
  j.stack_mem = stack_mem;
  j.stack_top = stack_top;
  j.in_buf = in_buf;
  j.out_buf = out_buf;
  j.counters = counters;
  j.retired = retired;
  j.acc_hi = acc_hi;
  j.bak_hi = bak_hi;
  const int64_t t0 = p->tracing() ? now_ns() : 0;
  const int rc = p->export_state();
  if (t0 != 0)
    p->tr_emit((int)p->workers.size(), t0, now_ns() - t0, TEV_EXPORT,
               (int64_t)(uint32_t)p->replicas.size() |
                   ((int64_t)(rc != 0) << 32));
  return rc;
}

void misaka_pool_discard(void* h) {
  auto* p = (Pool*)h;
  if (p->tracing() && p->resident) {
    const int64_t t0 = now_ns();
    p->tr_emit((int)p->workers.size(), t0, 0, TEV_DISCARD,
               (int64_t)(uint32_t)p->replicas.size());
  }
  p->resident = false;
  p->mark_all_dirty();
}

int misaka_pool_is_resident(void* h) {
  return ((Pool*)h)->resident ? 1 : 0;
}

// One resident serve (feed_counts non-null) or idle (null) pass.  packed
// gets EVERY row filled (active rows post-run, skipped rows their current
// counters + the drained-on-serve contract); progress (may be null) gets
// the per-replica retired-anything flags.  `reuse` nonzero declares that
// `packed` is the SAME buffer as the previous call of this kind (serve
// vs idle) with its contents intact — quiescent rows already current in
// it are then elided instead of rewritten (pass 0 for a fresh buffer).
// Returns 0, -2 (a feed exceeded a ring's free space — resident state
// untouched), -3 (invalid active list), or -4 (residency not armed:
// caller bug).
int misaka_pool_serve_resident(void* h, const int32_t* feed_vals,
                               const int32_t* feed_counts, int ticks,
                               const int32_t* active, int n_active,
                               int32_t* packed, uint8_t* progress,
                               int reuse) {
  auto* p = (Pool*)h;
  if (!p->resident) return -4;
  if (active != nullptr) {
    if (n_active < 0 || n_active > (int)p->replicas.size()) return -3;
    for (int i = 0; i < n_active; ++i) {
      if (active[i] < 0 || active[i] >= (int)p->replicas.size()) return -3;
      if (i > 0 && active[i] <= active[i - 1]) return -3;
    }
  }
  Pool::Job& j = p->job;
  j = Pool::Job{};
  j.feed_vals = feed_vals;
  j.feed_counts = feed_counts;
  j.ticks = ticks;
  j.feeding = feed_counts != nullptr;
  j.packed = packed;
  j.active = active;
  j.n_active = n_active;
  j.progress = progress;
  j.reuse = reuse;
  return p->run_resident_job();
}

}  // extern "C"
