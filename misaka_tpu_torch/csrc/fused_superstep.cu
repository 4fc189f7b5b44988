// Fused superstep kernel: num_steps ticks of B independent TIS networks in
// one launch, one CUDA thread per network instance.
//
// Replaces misaka_tpu/core/fused.py::make_fused_runner (the Pallas kernel
// `kernel` / `tick_body`, its big-capacity ref_gather / ref_scatter /
// ref_copy storage mode and its elide_dead_hi option), which
// misaka_tpu/runtime/master.py::_make_dp_fused_runner also launches once per
// shard.  It computes exactly what misaka_tpu_torch/core/step.py computes
// tick after tick, then the ring rebase (the plain version,
// misaka_tpu_torch/core/fused.py::plain_run), bit for bit.
//
// What bounds it on an H100: int32 instruction issue, and the load/store
// unit for the ring and stack accesses.  A lane-tick is a short chain of
// data-dependent steps (fetch, port consume, source select, one
// arbitration, the register commit) on a few dozen bytes of state, so the
// bytes a chunk must move are far below the card's rate and the
// instructions per lane-tick and their latency are not.  A ring or stack
// access is a 4-byte access to the instance's own row, one 32-byte sector
// per thread, walked in order.
//
// What the design does about it (NVIDIA H100 80GB HBM3, 700 W; add2,
// B=262144, caps 128/128/16, one 2048-tick chunk through the wrapper;
// intermediate builds timed in turns against each other, PERF.md):
//   1. Pre-decoded line records.  core/fused.py::decode_lines makes one
//      16-byte record per (line, lane), held in shared memory: the op, the
//      source kind, the port pass 1 consumes, the send destination already
//      checked against the network, the stack index already clipped, the
//      jump target (or len-1 for JRO) and the next line modulo the program
//      length.  Pass 1 reads the record's control word, pass 2 the whole
//      record in one 16-byte load; keeping every lane's record in registers
//      between the passes would cost 4 registers a lane, which the
//      geometry below cannot spare.  No division by a runtime value is
//      left in the tick loop (the ring slots are registers that wrap with a
//      compare), and the pc register is always a table line: an entry pc
//      off the table keeps its stored value until the lane's first commit,
//      which steps from it on a cold path.  The kernel went from 4.35 to
//      3.72 ms (the wrapper 5.44 -> 4.77 ms, still on the [rows, B] layout).
//   2. Whole waves.  The builds up to 4 lanes are compiled for 4 blocks of
//      256 threads per SM (`Geometry`): exactly 1024 threads, so B=262144
//      fills the 132 SMs in 1.94 waves rather than the 1.55 of 10 blocks
//      of 128 at 48 registers.  The 2-lane build needs 56 registers, so
//      one wave of 2048 threads per SM (32 registers) spills 144-156 bytes
//      (4.90 and 6.67 ms); 128-thread blocks built for 8 let 9 fit (1.72
//      waves): 3.97 against 3.94 ms, 3.97 against 3.70 ms on HI_DEAD, 8.90
//      against 7.44 ms at caps 1024.  The wider builds keep 128-thread
//      blocks with no register cap but ptxas's 255: nothing measured there
//      favours another shape.  The 32-lane HI_FULL and HI_MASK builds spill
//      24 bytes: 32 lanes' ACC/BAK (64-bit), pc, hold value and commit
//      count are 224 of the 255 registers a thread may hold, whatever the
//      geometry.
//   3. The public layout.  The kernel addresses every NetworkState field
//      as [B, ...] (port values and flags of a lane as one 16- and one
//      4-byte access), so the wrapper's ~40 transposes around each launch
//      become one contiguous clone per written field, `in_buf` is read
//      where it lies, and the ring rebase is folded into the write-back.
//      Around the kernel 0.99 ms of conversion became 0.15 ms of clones:
//      3.94 ms through the wrapper (kernel 3.75 ms, 14% of its 0.538 ms
//      operations bound).  The strided ring accesses cost nothing at caps
//      128 but do at caps 1024 (kernel 5.92 ms against 4.20 on [rows, B]),
//      where the chunk still fell from 15.40 to 7.44 ms (16.29 before
//      all three).
//
// The elided variant (elide_dead_hi, misaka_tpu/core/fused.py:100-134).
// The high word of a lane's 64-bit ACC/BAK is read only by its conditional
// jumps (JEZ/JNZ/JGZ/JLZ) and by a JRO whose source is ACC; the wire
// (ports, stacks, OUT) carries the low word, and add, sub and neg of the
// low word depend on the low words alone.  A lane with none of those
// readers is "hi-dead": the kernel keeps only its 32-bit low words, never
// loads or stores its acc_hi/bak_hi words (they keep their entry values,
// the reference's documented contract), and does no carry arithmetic for
// it.  The wrapper passes the live lanes as a bit mask (`hi_live`, every
// lane for the full kernel) and the C entry picks one of three
// instantiations from it (template parameter HI):
//   HI_FULL -- the mask covers every lane: every lane 64-bit;
//   HI_MASK -- live lanes 64-bit, dead lanes 32-bit, chosen per lane by
//              the mask (a warp-uniform test);
//   HI_DEAD -- mask 0, no live lane (add2): ACC/BAK are int32 registers.
//
// Bounds (checked by the Python wrapper, which raises ValueError naming the
// bound): n_lanes <= 32, n_stacks <= MAX_STACKS, line records within the
// shared-memory limit.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_NOP = 0, OP_SWP = 1, OP_SAV = 2, OP_NEG = 3, OP_MOV_LOCAL = 4,
              OP_MOV_NET = 5, OP_ADD = 6, OP_SUB = 7, OP_JMP = 8, OP_JEZ = 9,
              OP_JNZ = 10, OP_JGZ = 11, OP_JLZ = 12, OP_JRO = 13, OP_PUSH = 14,
              OP_POP = 15, OP_IN = 16, OP_OUT = 17;
// A line record (core/fused.py::decode_lines), one int4 per (line, lane):
//   x  the immediate source value (0 for NIL and for ops that read no source)
//   y  control: bits 0-4 op, 5-6 source kind, 7 "writes ACC", 24-31 the port
//      index n*4+k that pass 1 consumes, or NO_PORT
//   z  MOV_NET: destination port tgt*4+port, checked against n_lanes*4 (-1:
//      never delivers); PUSH/POP: stack index clipped to [0, n_stacks-1]
//   w  bits 0-15: jump target (JMP..JLZ) or len-1 (every other op);
//      bits 16-31: (line + 1) % len
constexpr int K_IMM = 0, K_ACC = 1, K_PORT = 2, K_HOLD = 3;
constexpr uint32_t CTL_WRITES_ACC = 1u << 7;
constexpr uint32_t NO_PORT = 0xFFu;
constexpr int NUM_PORTS = 4;
constexpr int MAX_STACKS = 16;
constexpr int32_t JRO_PRECLIP = 1 << 20;
constexpr int32_t REBASE_THRESHOLD = 1 << 30;
constexpr int HI_FULL = 0, HI_MASK = 1, HI_DEAD = 2;

// Launch geometry per lane bound: threads per block, and the resident
// blocks per SM the instantiation is compiled for (ptxas caps its registers
// at 65536 / (block * min_blocks), and at 255).  Up to 4 lanes, 4 blocks of
// 256 (52-64 registers) are exactly 1024 threads per SM: B=262144 runs in
// 1.94 waves over 132 SMs.  Wider builds keep 128-thread blocks and let
// their registers set the count (8 lanes: 5 blocks at 96-100 registers).
template <int MAXL>
struct Geometry {
  static constexpr int block = MAXL <= 4 ? 256 : 128;
  static constexpr int min_blocks = MAXL <= 4 ? 4 : 1;
};

typedef uint8_t Bool;  // torch.bool
// Word i of this instance's row of a [B, rows] field.
#define IDX(rows, i) ((size_t)b * (size_t)(rows) + (size_t)(i))

// The register type of ACC/BAK: int32 when no lane is hi-live.
template <int HI>
struct RegOf {
  using type = int64_t;
};
template <>
struct RegOf<HI_DEAD> {
  using type = int32_t;
};

// Is lane n hi-live under this instantiation and mask?
template <int HI>
__device__ __forceinline__ bool hi_live_lane(uint32_t mask, int n) {
  if (HI == HI_FULL) return true;
  if (HI == HI_DEAD) return false;
  return (mask >> n) & 1u;
}

// Floor modulo, as torch's `%` on int32 (n > 0).  Only at chunk entry and
// on the cold path of a lane whose entry pc lies outside its table.
__device__ __forceinline__ int32_t fmod_floor(int32_t x, int32_t n) {
  int32_t m = x % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int32_t inc32(int32_t x) {
  return (int32_t)((uint32_t)x + 1u);
}

// 64-bit wrapping arithmetic through unsigned (signed overflow is UB).
__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

__device__ __forceinline__ int64_t join64(int32_t hi, int32_t lo) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)(uint32_t)lo);
}
__device__ __forceinline__ int32_t lo32(int64_t x) {
  return (int32_t)(uint32_t)(uint64_t)x;
}
__device__ __forceinline__ int32_t hi32(int64_t x) {
  return (int32_t)(uint32_t)((uint64_t)x >> 32);
}

// ACC arithmetic of one lane: 64-bit on a hi-live lane, the low word
// alone (sign-extended back into the register) on a hi-dead one.
__device__ __forceinline__ int64_t reg_add(int64_t a, int64_t b, bool live) {
  return live ? wadd(a, b)
              : (int64_t)(int32_t)((uint32_t)lo32(a) + (uint32_t)lo32(b));
}
__device__ __forceinline__ int64_t reg_sub(int64_t a, int64_t b, bool live) {
  return live ? wsub(a, b)
              : (int64_t)(int32_t)((uint32_t)lo32(a) - (uint32_t)lo32(b));
}
__device__ __forceinline__ int32_t reg_add(int32_t a, int32_t b, bool) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t reg_sub(int32_t a, int32_t b, bool) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// core/regs64.py::jro_target on the 64-bit value v; `last` is len - 1.
__device__ __forceinline__ int32_t jro_target(int32_t pc, int64_t v,
                                              int32_t last) {
  int32_t lo = (int32_t)(uint32_t)(uint64_t)v;
  if (v == (int64_t)lo) {  // fits signed 32-bit
    int32_t lo_c = lo < -JRO_PRECLIP ? -JRO_PRECLIP
                                     : (lo > JRO_PRECLIP ? JRO_PRECLIP : lo);
    int32_t t = (int32_t)((uint32_t)pc + (uint32_t)lo_c);
    if (t < 0) t = 0;
    return t < last ? t : last;
  }
  return v < 0 ? 0 : last;
}

// Port-occupancy bit set over MAXL*4 ports.
template <int MAXL>
struct PortBits {
  static constexpr int WORDS = (MAXL * NUM_PORTS + 63) / 64;
  uint64_t w[WORDS];
  __device__ __forceinline__ uint64_t& word(int d) {
    if constexpr (WORDS == 1) return w[0];
    else return w[d >> 6];
  }
  __device__ __forceinline__ bool get(int d) { return (word(d) >> (d & 63)) & 1ull; }
  __device__ __forceinline__ void set(int d) { word(d) |= 1ull << (d & 63); }
  __device__ __forceinline__ void clear(int d) { word(d) &= ~(1ull << (d & 63)); }
};

struct Params {
  const int4* recs;         // [max_len, n_lanes] line records
  const int32_t* prog_len;  // [n_lanes]
  int n_lanes, max_len, n_stacks, stack_cap, in_cap, out_cap, batch,
      num_steps;
  uint32_t hi_live;  // bit n: lane n is hi-live (read under HI_MASK only)
  // the state, every field in its [B, ...] layout, updated in place
  int32_t *acc, *bak, *acc_hi, *bak_hi, *pc, *port_val;
  Bool* port_full;
  int32_t* hold_val;
  Bool* holding;
  int32_t *stack_mem, *stack_top;
  const int32_t* in_buf;
  int32_t *in_rd, *in_wr, *out_buf, *out_rd, *out_wr, *tick, *retired;
};

// Subtract a multiple of cap from a ring's counters once rd passes 2^30
// (core/state.py::rebase_rings; rd > 0 there, so / is a floor division).
__device__ __forceinline__ void rebase(int32_t& rd, int32_t& wr, int32_t cap) {
  if (rd > REBASE_THRESHOLD) {
    const int32_t base = rd / cap * cap;
    rd -= base;
    wr = (int32_t)((uint32_t)wr - (uint32_t)base);
  }
}

template <int MAXL, int HI>
__global__ void __launch_bounds__(Geometry<MAXL>::block, Geometry<MAXL>::min_blocks)
    fused_superstep_kernel(const Params p) {
  using Reg = typename RegOf<HI>::type;
  extern __shared__ int4 recs_s[];  // [max_len * n_lanes]
  const int n_recs = p.max_len * p.n_lanes;
  for (int i = threadIdx.x; i < n_recs; i += blockDim.x) recs_s[i] = p.recs[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  const int nl = p.n_lanes;
  const int S = p.n_stacks;
  const int cap = p.stack_cap;

  // ---- load the instance's state ----------------------------------------
  Reg acc[MAXL], bak[MAXL];
  int32_t pc[MAXL], hv[MAXL], ret[MAXL];
  int32_t pv[MAXL * NUM_PORTS];  // indexed by data: local memory (L1)
  int32_t st[MAX_STACKS];
  PortBits<MAXL> pf;
#pragma unroll
  for (int w = 0; w < PortBits<MAXL>::WORDS; ++w) pf.w[w] = 0;
  uint32_t hold = 0;
  uint32_t oor = 0;  // lanes whose entry pc lies outside [0, max_len - 1]
#pragma unroll
  for (int n = 0; n < MAXL; ++n) {
    if (n < nl) {
      const size_t o = IDX(nl, n);
      if (hi_live_lane<HI>(p.hi_live, n)) {
        acc[n] = (Reg)join64(p.acc_hi[o], p.acc[o]);
        bak[n] = (Reg)join64(p.bak_hi[o], p.bak[o]);
      } else {  // hi-dead: the low words only, hi words never touched
        acc[n] = (Reg)p.acc[o];
        bak[n] = (Reg)p.bak[o];
      }
      const int32_t pcn = p.pc[o];
      // the register is the table line step.py fetches (a negative pc
      // counts from the table's end, then clamps); the stored pc stays the
      // entry value until the lane commits
      if (pcn < 0 || pcn >= p.max_len) {
        oor |= 1u << n;
        pc[n] = pcn >= 0 ? p.max_len - 1 : max(pcn + p.max_len, 0);
      } else {
        pc[n] = pcn;
      }
      hv[n] = p.hold_val[o];
      ret[n] = p.retired[o];
      if (p.holding[o]) hold |= 1u << n;
      const size_t q = IDX(nl * NUM_PORTS, n * NUM_PORTS);
      const int4 v = *reinterpret_cast<const int4*>(p.port_val + q);
      pv[n * NUM_PORTS + 0] = v.x;
      pv[n * NUM_PORTS + 1] = v.y;
      pv[n * NUM_PORTS + 2] = v.z;
      pv[n * NUM_PORTS + 3] = v.w;
      const uint32_t f = *reinterpret_cast<const uint32_t*>(p.port_full + q);
      const uint64_t nib =
          (f & 1u) | ((f >> 7) & 2u) | ((f >> 14) & 4u) | ((f >> 21) & 8u);
      pf.word(n * NUM_PORTS) |= nib << ((n * NUM_PORTS) & 63);
    }
  }
  for (int s = 0; s < S; ++s) st[s] = p.stack_top[IDX(S, s)];
  int32_t in_rd = p.in_rd[b];
  const int32_t in_wr = p.in_wr[b];
  const int32_t out_rd = p.out_rd[b];
  int32_t out_wr = p.out_wr[b];
  // ring slots, carried as registers that wrap with a compare
  int32_t in_slot = fmod_floor(in_rd, p.in_cap);
  int32_t out_slot = fmod_floor(out_wr, p.out_cap);

  for (int t = 0; t < p.num_steps; ++t) {
    // ---- pass 1: consume ready port sources into the hold latches -------
#pragma unroll
    for (int n = 0; n < MAXL; ++n) {
      if (n < nl) {
        const uint32_t d = (uint32_t)recs_s[pc[n] * nl + n].y >> 24;
        if (d != NO_PORT && !((hold >> n) & 1u) && pf.get(d)) {
          hv[n] = pv[d];
          hold |= 1u << n;
          pf.clear(d);
        }
      }
    }

    // ---- pass 2: per lane, lowest first: resolve, arbitrate, commit -----
    const bool in_avail = (int32_t)((uint32_t)in_wr - (uint32_t)in_rd) > 0;
    const bool out_free =
        (int32_t)((uint32_t)out_wr - (uint32_t)out_rd) < p.out_cap;
    bool in_taken = false, out_taken = false;
    uint32_t stack_taken = 0;
#pragma unroll
    for (int n = 0; n < MAXL; ++n) {
      if (n < nl) {
        const uint32_t bit = 1u << n;
        const int4 r = recs_s[pc[n] * nl + n];
        const uint32_t ctl = (uint32_t)r.y;
        const int op = ctl & 31u;
        const int kind = (ctl >> 5) & 3u;

        // source operand: ACC keeps its width, the rest sign-extend
        Reg sv = kind == K_ACC ? acc[n] : (Reg)(kind >= K_PORT ? hv[n] : r.x);
        const bool src_ok = kind != K_PORT || (hold & bit);
        const int32_t wire = lo32(sv);

        bool commit = src_ok;
        int32_t incoming = 0;  // POP / IN value for an ACC destination
        if (op == OP_MOV_NET) {
          const int d = r.z;  // -1: a destination no lane has
          commit = src_ok && d >= 0 && !pf.get(d);
          if (commit) {
            pf.set(d);
            pv[d] = wire;
          }
        } else if (op == OP_PUSH || op == OP_POP) {
          const int s = r.z;
          commit = false;
          if (!((stack_taken >> s) & 1u)) {
            const int32_t top = st[s];
            if (op == OP_PUSH) {
              if (src_ok && top < cap) {
                const int slot = top < 0 ? 0 : top;  // step.py's clip
                p.stack_mem[IDX(S * cap, s * cap + slot)] = wire;
                st[s] = top + 1;
                stack_taken |= 1u << s;
                commit = true;
              }
            } else if (top > 0) {
              incoming = p.stack_mem[IDX(S * cap, s * cap + min(top - 1, cap - 1))];
              st[s] = top - 1;
              stack_taken |= 1u << s;
              commit = true;
            }
          }
        } else if (op == OP_IN) {
          commit = in_avail && !in_taken;
          if (commit) {
            incoming = p.in_buf[IDX(p.in_cap, in_slot)];
            in_taken = true;
          }
        } else if (op == OP_OUT) {
          commit = src_ok && out_free && !out_taken;
          if (commit) {
            p.out_buf[IDX(p.out_cap, out_slot)] = wire;
            out_taken = true;
          }
        }

        if (commit) {
          const Reg a = acc[n];  // begin-of-tick acc (jump conditions)
          const bool live = hi_live_lane<HI>(p.hi_live, n);
          switch (op) {
            case OP_MOV_LOCAL:
              if (ctl & CTL_WRITES_ACC) acc[n] = sv;
              break;
            case OP_POP:
            case OP_IN:
              if (ctl & CTL_WRITES_ACC) acc[n] = (Reg)incoming;
              break;
            case OP_ADD: acc[n] = reg_add(a, sv, live); break;
            case OP_SUB: acc[n] = reg_sub(a, sv, live); break;
            case OP_NEG: acc[n] = reg_sub((Reg)0, a, live); break;
            case OP_SWP: acc[n] = bak[n]; bak[n] = a; break;
            case OP_SAV: bak[n] = a; break;
            default: break;
          }
          const uint32_t jw = (uint32_t)r.w;
          const int32_t jmp = (int32_t)(jw & 0xFFFFu);
          int32_t npc;
          if (op == OP_JMP || (op == OP_JEZ && a == 0) ||
              (op == OP_JNZ && a != 0) || (op == OP_JGZ && a > 0) ||
              (op == OP_JLZ && a < 0)) {
            npc = jmp;
          } else if (oor & bit) {
            // cold: the first commit of a lane whose entry pc is off its
            // table steps from that pc (still in memory: written at exit)
            const int32_t raw = p.pc[IDX(nl, n)];
            const int32_t len = p.prog_len[n];
            npc = op == OP_JRO ? jro_target(raw, (int64_t)sv, len - 1)
                               : fmod_floor(inc32(raw), len);
          } else if (op == OP_JRO) {
            npc = jro_target(pc[n], (int64_t)sv, jmp);
          } else {
            npc = (int32_t)(jw >> 16);
          }
          oor &= ~bit;
          pc[n] = npc;
          hold &= ~bit;
          ret[n] = inc32(ret[n]);
        }
      }
    }
    if (in_taken) {
      in_rd = inc32(in_rd);
      in_slot = in_slot + 1 == p.in_cap ? 0 : in_slot + 1;
      if (in_rd == INT32_MIN) in_slot = fmod_floor(in_rd, p.in_cap);
    }
    if (out_taken) {
      out_wr = inc32(out_wr);
      out_slot = out_slot + 1 == p.out_cap ? 0 : out_slot + 1;
      if (out_wr == INT32_MIN) out_slot = fmod_floor(out_wr, p.out_cap);
    }
  }

  // ---- write the instance's state back ----------------------------------
#pragma unroll
  for (int n = 0; n < MAXL; ++n) {
    if (n < nl) {
      const size_t o = IDX(nl, n);
      p.acc[o] = lo32(acc[n]);
      p.bak[o] = lo32(bak[n]);
      if (hi_live_lane<HI>(p.hi_live, n)) {
        p.acc_hi[o] = hi32(acc[n]);
        p.bak_hi[o] = hi32(bak[n]);
      }
      if (!((oor >> n) & 1u)) p.pc[o] = pc[n];
      p.hold_val[o] = hv[n];
      p.holding[o] = (hold >> n) & 1u;
      p.retired[o] = ret[n];
      const size_t q = IDX(nl * NUM_PORTS, n * NUM_PORTS);
      *reinterpret_cast<int4*>(p.port_val + q) =
          make_int4(pv[n * NUM_PORTS + 0], pv[n * NUM_PORTS + 1],
                    pv[n * NUM_PORTS + 2], pv[n * NUM_PORTS + 3]);
      const uint32_t nib =
          (uint32_t)(pf.word(n * NUM_PORTS) >> ((n * NUM_PORTS) & 63)) & 15u;
      *reinterpret_cast<uint32_t*>(p.port_full + q) =
          (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) | ((nib & 8u) << 21);
    }
  }
  for (int s = 0; s < S; ++s) p.stack_top[IDX(S, s)] = st[s];
  int32_t in_wr_out = in_wr, out_rd_out = out_rd;
  rebase(in_rd, in_wr_out, p.in_cap);
  rebase(out_rd_out, out_wr, p.out_cap);
  p.in_rd[b] = in_rd;
  p.in_wr[b] = in_wr_out;
  p.out_rd[b] = out_rd_out;
  p.out_wr[b] = out_wr;
  p.tick[b] = (int32_t)((uint32_t)p.tick[b] + (uint32_t)p.num_steps);
}

using KernelFn = void (*)(Params);

// An instantiation and its launch shape.
struct Launch {
  KernelFn fn;
  int block;
  size_t smem;  // the line records, bytes of dynamic shared memory
};

template <int MAXL>
Launch pick_mode(int mode) {
  constexpr int block = Geometry<MAXL>::block;
  if (mode == HI_MASK) return {fused_superstep_kernel<MAXL, HI_MASK>, block, 0};
  if (mode == HI_DEAD) return {fused_superstep_kernel<MAXL, HI_DEAD>, block, 0};
  return {fused_superstep_kernel<MAXL, HI_FULL>, block, 0};
}

// The instantiation for n_lanes program lanes (1..32), a hi mode and
// max_len-line tables, with its shared-memory limit raised where the
// records need more than the default 48 KB.
cudaError_t pick(int n_lanes, int max_len, int mode, Launch* out) {
  Launch l = n_lanes <= 2    ? pick_mode<2>(mode)
             : n_lanes <= 4  ? pick_mode<4>(mode)
             : n_lanes <= 8  ? pick_mode<8>(mode)
             : n_lanes <= 16 ? pick_mode<16>(mode)
                             : pick_mode<32>(mode);
  l.smem = (size_t)max_len * n_lanes * sizeof(int4);
  *out = l;
  if (l.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)l.smem);
}

}  // namespace

extern "C" {

// Largest lane count and stack count the kernel takes (the wrapper checks).
int misaka_fused_max_lanes() { return 32; }
int misaka_fused_max_stacks() { return MAX_STACKS; }

// Resident blocks per SM and threads per block of the instantiation that
// runs n_lanes lanes of max_len-line tables in hi mode hi_mode (0 full,
// 1 mask, 2 all hi-dead), with the shared memory its launch reserves.
// Returns a cudaError_t (0 = ok).
int misaka_fused_occupancy(int n_lanes, int max_len, int hi_mode,
                           int* blocks_per_sm, int* block_size) {
  if (n_lanes < 1 || n_lanes > 32 || max_len < 1 || max_len > 0xFFFF ||
      hi_mode < HI_FULL || hi_mode > HI_DEAD)
    return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = pick(n_lanes, max_len, hi_mode, &l);
  if (e != cudaSuccess) return (int)e;
  *block_size = l.block;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, l.fn,
                                                            l.block, l.smem);
}

// Advance `num_steps` ticks in place on the [B, ...] state fields (given in
// NetworkState order), then rebase the rings.  `recs` holds the
// [max_len, n_lanes] line records (16 bytes each).  `hi_live` is the lane
// mask (bit n: lane n has a 64-bit reader): a mask that covers every lane
// runs the full kernel, any other the elided variant.  Returns the launch's
// cudaError_t (0 = launched).
int misaka_fused_superstep(
    const void* recs, const int32_t* prog_len, int n_lanes, int max_len,
    int n_stacks, int stack_cap, int in_cap, int out_cap, int batch,
    int num_steps, unsigned int hi_live, int32_t* acc, int32_t* bak,
    int32_t* acc_hi, int32_t* bak_hi, int32_t* pc, int32_t* port_val,
    void* port_full, int32_t* hold_val, void* holding, int32_t* stack_mem,
    int32_t* stack_top, const int32_t* in_buf, int32_t* in_rd, int32_t* in_wr,
    int32_t* out_buf, int32_t* out_rd, int32_t* out_wr, int32_t* tick,
    int32_t* retired, void* stream) {
  if (n_lanes < 1 || n_lanes > 32 || n_stacks < 1 || n_stacks > MAX_STACKS ||
      batch < 1 || max_len < 1 || max_len > 0xFFFF)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.recs = static_cast<const int4*>(recs);
  p.prog_len = prog_len;
  p.n_lanes = n_lanes;
  p.max_len = max_len;
  p.n_stacks = n_stacks;
  p.stack_cap = stack_cap;
  p.in_cap = in_cap;
  p.out_cap = out_cap;
  p.batch = batch;
  p.num_steps = num_steps;
  p.acc = acc;
  p.bak = bak;
  p.acc_hi = acc_hi;
  p.bak_hi = bak_hi;
  p.pc = pc;
  p.port_val = port_val;
  p.port_full = static_cast<Bool*>(port_full);
  p.hold_val = hold_val;
  p.holding = static_cast<Bool*>(holding);
  p.stack_mem = stack_mem;
  p.stack_top = stack_top;
  p.in_buf = in_buf;
  p.in_rd = in_rd;
  p.in_wr = in_wr;
  p.out_buf = out_buf;
  p.out_rd = out_rd;
  p.out_wr = out_wr;
  p.tick = tick;
  p.retired = retired;
  const uint32_t all = n_lanes == 32 ? 0xffffffffu : (1u << n_lanes) - 1u;
  p.hi_live = (uint32_t)hi_live & all;
  const int mode = p.hi_live == all ? HI_FULL : (p.hi_live == 0 ? HI_DEAD : HI_MASK);
  Launch l;
  cudaError_t e = pick(n_lanes, max_len, mode, &l);
  if (e != cudaSuccess) return (int)e;
  const int grid = (batch + l.block - 1) / l.block;
  l.fn<<<grid, l.block, l.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
