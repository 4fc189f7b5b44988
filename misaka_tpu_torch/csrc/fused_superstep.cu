// Fused superstep kernel: num_steps ticks of B independent TIS networks in
// one launch, one CUDA thread per network instance.
//
// Replaces misaka_tpu/core/fused.py::make_fused_runner (the Pallas kernel
// `kernel` / `tick_body`, including its big-capacity ref_gather /
// ref_scatter / ref_copy storage mode).  It computes exactly what
// misaka_tpu_torch/core/step.py computes tick after tick (the plain
// version, misaka_tpu_torch/core/fused.py::plain_run), bit for bit.
//
// What bounds it on an H100: integer instruction issue and latency.  Every
// tick is a short chain of data-dependent branches per lane (fetch, port
// consume, source select, one arbitration, register commit), and the state
// an instance touches per tick is a few dozen bytes, so device-memory
// bandwidth is not the limit; the int32 issue rate and the dependent
// latency of that chain are.  Warp divergence costs too: threads of a warp
// that sit at different program lines execute both sides of a branch.
//
// What the design does about it:
//   * One thread per instance, the whole chunk in one launch: no state
//     round-trips device memory between ticks.  Registers (acc/bak as
//     int64, pc, hold latch, retired) and the port file live in the thread
//     for the whole chunk; the per-lane loops are unrolled over a
//     compile-time lane bound MAXL so lane-indexed state can stay in
//     registers.
//   * Port occupancy and hold latches are bit masks, so a send to a
//     data-dependent port is a shift, not an indexed select chain.
//   * Stacks and the I/O rings stay in device memory in a structure-of-
//     arrays [rows, B] layout (row r of instance b at r*B + b): neighbouring
//     threads touch neighbouring words, and a push/pop/IN/OUT is one direct
//     indexed load or store -- the TPU kernel's chunked scans are gone.
//   * The program tables sit in shared memory, loaded once per block, so
//     one build serves every program and every /load.
//   * Lanes are visited in ascending order, which IS the lowest-lane-wins
//     arbitration: a resource taken by a lower lane this tick is simply
//     seen as taken.  Sends see ports freed by this tick's consumes because
//     all consumes (pass 1) run before any send (pass 2).  Registers are
//     lane-private, so committing a lane in place still reads its own
//     begin-of-tick acc/bak.
//
// The elided variant (elide_dead_hi, misaka_tpu/core/fused.py:100-134).
// The high word of a lane's 64-bit ACC/BAK is read only by its conditional
// jumps (JEZ/JNZ/JGZ/JLZ) and by a JRO whose source is ACC; the wire
// (ports, stacks, OUT) carries the low word, and add, sub and neg of the
// low word depend on the low words alone.  A lane with none of those
// readers is "hi-dead": the kernel keeps only its 32-bit low words, never
// loads or stores its acc_hi/bak_hi rows (they keep their entry values,
// the reference's documented contract), and does no carry arithmetic for
// it.  Every other plane stays bit-identical to the full kernel.  The
// wrapper passes the live lanes as a bit mask (`hi_live`, every lane for the
// full kernel) and the C entry picks one of three instantiations from it
// (template parameter HI):
//   HI_FULL -- the mask covers every lane: every lane 64-bit;
//   HI_MASK -- live lanes 64-bit, dead lanes 32-bit, chosen per lane by
//              the mask (a warp-uniform test: every thread of a launch runs
//              the same programs);
//   HI_DEAD -- mask 0, no live lane (add2: neither of its programs
//              branches): ACC/BAK are int32 registers outright.
// What it saves on this card: per dead lane and chunk, two [1, B] rows of
// loads and two of stores (16 bytes per instance), and per committed
// ADD/SUB/NEG the carry chain of wadd/wsub.  Alone that is nothing against
// a chunk's 2048 ticks of fetch-and-branch work: on an H100 80GB HBM3 at
// 700 W, HI_MASK with mask 0 ran the add2 chunk (B=262144) in the full
// kernel's time, while HI_DEAD took 3.7% off it (5.40 -> 5.20 ms through
// the wrapper, timed in turns in one call; PERF.md).  What HI_DEAD adds is
// ACC/BAK in 32-bit registers: ptxas gives it 40/56/72/149/236 registers
// for the 2/4/8/16/32-lane builds against 48/64/96/188/255 for HI_FULL and
// HI_MASK, and the 32-lane build's spills go.
//
// Bounds (checked by the Python wrapper, which raises ValueError naming the
// bound): n_lanes <= 32, n_stacks <= MAX_STACKS, code tables within the
// shared-memory limit.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NFIELDS = 7;
constexpr int F_OP = 0, F_SRC = 1, F_IMM = 2, F_DST = 3, F_TGT = 4, F_PORT = 5,
              F_JMP = 6;

constexpr int OP_NOP = 0, OP_SWP = 1, OP_SAV = 2, OP_NEG = 3, OP_MOV_LOCAL = 4,
              OP_MOV_NET = 5, OP_ADD = 6, OP_SUB = 7, OP_JMP = 8, OP_JEZ = 9,
              OP_JNZ = 10, OP_JGZ = 11, OP_JLZ = 12, OP_JRO = 13, OP_PUSH = 14,
              OP_POP = 15, OP_IN = 16, OP_OUT = 17;
constexpr int SRC_IMM = 0, SRC_ACC = 1, SRC_NIL = 2, SRC_R0 = 3;
constexpr int DST_ACC = 0;
constexpr int NUM_PORTS = 4;
constexpr int MAX_STACKS = 16;
constexpr int32_t JRO_PRECLIP = 1 << 20;
constexpr int BLOCK = 128;
constexpr int HI_FULL = 0, HI_MASK = 1, HI_DEAD = 2;

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

__device__ __forceinline__ bool reads_src(int op) {
  return op == OP_MOV_LOCAL || op == OP_MOV_NET || op == OP_ADD ||
         op == OP_SUB || op == OP_JRO || op == OP_PUSH || op == OP_OUT;
}

// Floor modulo, as torch's and jnp's `%` on int32 (n > 0).
__device__ __forceinline__ int32_t fmod_floor(int32_t x, int32_t n) {
  int32_t m = x % n;
  return m < 0 ? m + n : m;
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

// core/regs64.py::jro_target on the 64-bit value v.
__device__ __forceinline__ int32_t jro_target(int32_t pc, int64_t v,
                                              int32_t len) {
  int32_t lo = (int32_t)(uint32_t)(uint64_t)v;
  if (v == (int64_t)lo) {  // fits signed 32-bit
    int32_t lo_c = lo < -JRO_PRECLIP ? -JRO_PRECLIP
                                     : (lo > JRO_PRECLIP ? JRO_PRECLIP : lo);
    int32_t t = (int32_t)((uint32_t)pc + (uint32_t)lo_c);
    if (t < 0) t = 0;
    return t < len - 1 ? t : len - 1;
  }
  return v < 0 ? 0 : len - 1;
}

// Port-occupancy bit set over MAXL*4 ports.
template <int MAXL>
struct PortBits {
  static constexpr int WORDS = (MAXL * NUM_PORTS + 63) / 64;
  uint64_t w[WORDS];
  __device__ __forceinline__ bool get(int d) const {
    return (w[d >> 6] >> (d & 63)) & 1ull;
  }
  __device__ __forceinline__ void set(int d) { w[d >> 6] |= 1ull << (d & 63); }
  __device__ __forceinline__ void clear(int d) {
    w[d >> 6] &= ~(1ull << (d & 63));
  }
};

struct Params {
  const int32_t* code;      // [n_lanes, max_len, NFIELDS]
  const int32_t* prog_len;  // [n_lanes]
  int n_lanes, max_len, n_stacks, stack_cap, in_cap, out_cap, batch,
      num_steps;
  uint32_t hi_live;  // bit n: lane n is hi-live (read under HI_MASK only)
  // [rows, B] structure-of-arrays state, updated in place
  int32_t *acc, *bak, *acc_hi, *bak_hi, *pc, *port_val, *port_full, *hold_val,
      *holding, *stack_mem, *stack_top, *out_buf, *sc, *retired;
  const int32_t* in_buf;
};

template <int MAXL, int HI>
__global__ void __launch_bounds__(BLOCK)
    fused_superstep_kernel(const Params p) {
  using Reg = typename RegOf<HI>::type;
  extern __shared__ int32_t smem[];
  int32_t* code_s = smem;  // [n_lanes * max_len * NFIELDS]
  int32_t* len_s = smem + p.n_lanes * p.max_len * NFIELDS;
  const int code_words = p.n_lanes * p.max_len * NFIELDS;
  for (int i = threadIdx.x; i < code_words; i += blockDim.x)
    code_s[i] = p.code[i];
  for (int i = threadIdx.x; i < p.n_lanes; i += blockDim.x)
    len_s[i] = p.prog_len[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  const size_t B = (size_t)p.batch;
  const int nl = p.n_lanes;
  const int L = p.max_len;
  const int S = p.n_stacks;
  const int cap = p.stack_cap;

  // ---- load the instance's state ----------------------------------------
  Reg acc[MAXL], bak[MAXL];
  int32_t pc[MAXL], hv[MAXL], ret[MAXL];
  int32_t pv[MAXL * NUM_PORTS];
  PortBits<MAXL> pf;
  uint32_t hold = 0;
#pragma unroll
  for (int w = 0; w < PortBits<MAXL>::WORDS; ++w) pf.w[w] = 0;
#pragma unroll
  for (int n = 0; n < MAXL; ++n) {
    if (n < nl) {
      const size_t o = (size_t)n * B + b;
      if (hi_live_lane<HI>(p.hi_live, n)) {
        acc[n] = (Reg)join64(p.acc_hi[o], p.acc[o]);
        bak[n] = (Reg)join64(p.bak_hi[o], p.bak[o]);
      } else {  // hi-dead: the low words only, hi rows never touched
        acc[n] = (Reg)p.acc[o];
        bak[n] = (Reg)p.bak[o];
      }
      pc[n] = p.pc[o];
      hv[n] = p.hold_val[o];
      ret[n] = p.retired[o];
      if (p.holding[o]) hold |= 1u << n;
#pragma unroll
      for (int k = 0; k < NUM_PORTS; ++k) {
        const int d = n * NUM_PORTS + k;
        pv[d] = p.port_val[(size_t)d * B + b];
        if (p.port_full[(size_t)d * B + b]) pf.set(d);
      }
    }
  }
  int32_t st[MAX_STACKS];
  for (int s = 0; s < S; ++s) st[s] = p.stack_top[(size_t)s * B + b];
  int32_t in_rd = p.sc[0 * B + b];
  const int32_t in_wr = p.sc[1 * B + b];
  const int32_t out_rd = p.sc[2 * B + b];
  int32_t out_wr = p.sc[3 * B + b];
  int32_t tick = p.sc[4 * B + b];
  int32_t* const stack_mem = p.stack_mem;
  int32_t* const out_buf = p.out_buf;
  const int32_t* const in_buf = p.in_buf;

  for (int t = 0; t < p.num_steps; ++t) {
    // ---- pass 1: consume ready port sources into the hold latches -------
#pragma unroll
    for (int n = 0; n < MAXL; ++n) {
      if (n < nl) {
        const int line = min(max(pc[n], 0), L - 1);
        const int32_t* ins = code_s + (n * L + line) * NFIELDS;
        const int op = ins[F_OP], src = ins[F_SRC];
        if (reads_src(op) && src >= SRC_R0 && !((hold >> n) & 1u)) {
          const int d = n * NUM_PORTS + (src - SRC_R0);
          if (pf.get(d)) {
            hv[n] = pv[d];
            hold |= 1u << n;
            pf.clear(d);
          }
        }
      }
    }

    // ---- pass 2: per lane, lowest first: resolve, arbitrate, commit -----
    const bool in_avail = in_wr - in_rd > 0;        // begin-of-tick
    const bool out_free = out_wr - out_rd < p.out_cap;
    bool in_taken = false, out_taken = false;
    uint32_t stack_taken = 0;
#pragma unroll
    for (int n = 0; n < MAXL; ++n) {
      if (n < nl) {
        const int32_t pcn = pc[n];
        const int line = min(max(pcn, 0), L - 1);
        const int32_t* ins = code_s + (n * L + line) * NFIELDS;
        const int op = ins[F_OP];
        const int src = ins[F_SRC];

        // source operand: register width (ACC keeps its width, the rest
        // sign-extend)
        bool src_ok = true;
        Reg sv = 0;
        if (reads_src(op)) {
          if (src == SRC_IMM) {
            sv = ins[F_IMM];
          } else if (src == SRC_ACC) {
            sv = acc[n];
          } else if (src >= SRC_R0) {
            sv = hv[n];
            src_ok = (hold >> n) & 1u;
          }
        }
        const int32_t wire = lo32(sv);  // sint32

        bool commit = src_ok;
        int32_t incoming = 0;  // POP / IN value for an ACC destination
        if (op == OP_MOV_NET) {
          commit = false;
          if (src_ok) {
            const int d = ins[F_TGT] * NUM_PORTS + ins[F_PORT];
            if (d >= 0 && d < nl * NUM_PORTS && !pf.get(d)) {
              pf.set(d);
              pv[d] = wire;
              commit = true;
            }
          }
        } else if (op == OP_PUSH || op == OP_POP) {
          commit = false;
          const int s = min(max(ins[F_TGT], 0), S - 1);
          if (!((stack_taken >> s) & 1u)) {
            const int32_t top = st[s];
            if (op == OP_PUSH) {
              if (src_ok && top < cap) {
                const int slot = top < 0 ? 0 : top;  // step.py's clip
                stack_mem[((size_t)s * cap + slot) * B + b] = wire;
                st[s] = top + 1;
                stack_taken |= 1u << s;
                commit = true;
              }
            } else if (top > 0) {
              incoming =
                  stack_mem[((size_t)s * cap + min(top - 1, cap - 1)) * B + b];
              st[s] = top - 1;
              stack_taken |= 1u << s;
              commit = true;
            }
          }
        } else if (op == OP_IN) {
          commit = false;
          if (in_avail && !in_taken) {
            incoming = in_buf[(size_t)fmod_floor(in_rd, p.in_cap) * B + b];
            in_taken = true;
            commit = true;
          }
        } else if (op == OP_OUT) {
          commit = false;
          if (src_ok && out_free && !out_taken) {
            out_buf[(size_t)fmod_floor(out_wr, p.out_cap) * B + b] = wire;
            out_taken = true;
            commit = true;
          }
        }

        if (commit) {
          const Reg a = acc[n];  // begin-of-tick acc (jump conditions)
          const bool live = hi_live_lane<HI>(p.hi_live, n);
          const int dst = ins[F_DST];
          switch (op) {
            case OP_MOV_LOCAL:
              if (dst == DST_ACC) acc[n] = sv;
              break;
            case OP_POP:
            case OP_IN:
              if (dst == DST_ACC) acc[n] = (Reg)incoming;
              break;
            case OP_ADD: acc[n] = reg_add(a, sv, live); break;
            case OP_SUB: acc[n] = reg_sub(a, sv, live); break;
            case OP_NEG: acc[n] = reg_sub((Reg)0, a, live); break;
            case OP_SWP: acc[n] = bak[n]; bak[n] = a; break;
            case OP_SAV: bak[n] = a; break;
            default: break;
          }
          const int32_t len = len_s[n];
          const int32_t jmp = ins[F_JMP];
          int32_t npc = fmod_floor((int32_t)((uint32_t)pcn + 1u), len);
          if (op == OP_JMP || (op == OP_JEZ && a == 0) ||
              (op == OP_JNZ && a != 0) || (op == OP_JGZ && a > 0) ||
              (op == OP_JLZ && a < 0)) {
            npc = jmp;
          } else if (op == OP_JRO) {
            npc = jro_target(pcn, (int64_t)sv, len);
          }
          pc[n] = npc;
          hold &= ~(1u << n);
          ret[n] += 1;
        }
      }
    }
    in_rd += in_taken ? 1 : 0;
    out_wr += out_taken ? 1 : 0;
    tick += 1;
  }

  // ---- write the instance's state back ----------------------------------
#pragma unroll
  for (int n = 0; n < MAXL; ++n) {
    if (n < nl) {
      const size_t o = (size_t)n * B + b;
      p.acc[o] = lo32(acc[n]);
      p.bak[o] = lo32(bak[n]);
      if (hi_live_lane<HI>(p.hi_live, n)) {
        p.acc_hi[o] = hi32(acc[n]);
        p.bak_hi[o] = hi32(bak[n]);
      }
      p.pc[o] = pc[n];
      p.hold_val[o] = hv[n];
      p.holding[o] = (hold >> n) & 1u;
      p.retired[o] = ret[n];
#pragma unroll
      for (int k = 0; k < NUM_PORTS; ++k) {
        const int d = n * NUM_PORTS + k;
        p.port_val[(size_t)d * B + b] = pv[d];
        p.port_full[(size_t)d * B + b] = pf.get(d) ? 1 : 0;
      }
    }
  }
  for (int s = 0; s < S; ++s) p.stack_top[(size_t)s * B + b] = st[s];
  p.sc[0 * B + b] = in_rd;
  p.sc[3 * B + b] = out_wr;
  p.sc[4 * B + b] = tick;
}

template <int MAXL, int HI>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      ((size_t)p.n_lanes * p.max_len * NFIELDS + p.n_lanes) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_superstep_kernel<MAXL, HI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (p.batch + BLOCK - 1) / BLOCK;
  fused_superstep_kernel<MAXL, HI><<<grid, BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MAXL>
cudaError_t launch_mode(const Params& p, int mode, cudaStream_t stream) {
  if (mode == HI_MASK) return launch<MAXL, HI_MASK>(p, stream);
  if (mode == HI_DEAD) return launch<MAXL, HI_DEAD>(p, stream);
  return launch<MAXL, HI_FULL>(p, stream);
}

}  // namespace

extern "C" {

// Largest lane count and stack count the kernel takes (the wrapper checks).
int misaka_fused_max_lanes() { return 32; }
int misaka_fused_max_stacks() { return MAX_STACKS; }

// Advance `num_steps` ticks in place on the [rows, B] state buffers.
// `hi_live` is the lane mask (bit n: lane n has a 64-bit reader): a mask
// that covers every lane runs the full kernel, any other the elided
// variant.  Returns the launch's cudaError_t (0 = launched).
int misaka_fused_superstep(
    const int32_t* code, const int32_t* prog_len, int n_lanes, int max_len,
    int n_stacks, int stack_cap, int in_cap, int out_cap, int batch,
    int num_steps, unsigned int hi_live, int32_t* acc,
    int32_t* bak, int32_t* acc_hi, int32_t* bak_hi, int32_t* pc,
    int32_t* port_val, int32_t* port_full, int32_t* hold_val,
    int32_t* holding, int32_t* stack_mem, int32_t* stack_top,
    int32_t* out_buf, int32_t* sc, int32_t* retired, const int32_t* in_buf,
    void* stream) {
  Params p;
  p.code = code;
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
  p.port_full = port_full;
  p.hold_val = hold_val;
  p.holding = holding;
  p.stack_mem = stack_mem;
  p.stack_top = stack_top;
  p.out_buf = out_buf;
  p.sc = sc;
  p.retired = retired;
  p.in_buf = in_buf;
  if (n_lanes < 1 || n_lanes > 32 || n_stacks < 1 || n_stacks > MAX_STACKS ||
      batch < 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t all = n_lanes == 32 ? 0xffffffffu : (1u << n_lanes) - 1u;
  p.hi_live = (uint32_t)hi_live & all;
  const int mode = p.hi_live == all ? HI_FULL : (p.hi_live == 0 ? HI_DEAD : HI_MASK);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (n_lanes <= 2) e = launch_mode<2>(p, mode, s);
  else if (n_lanes <= 4) e = launch_mode<4>(p, mode, s);
  else if (n_lanes <= 8) e = launch_mode<8>(p, mode, s);
  else if (n_lanes <= 16) e = launch_mode<16>(p, mode, s);
  else e = launch_mode<32>(p, mode, s);
  return (int)e;
}

}  // extern "C"
