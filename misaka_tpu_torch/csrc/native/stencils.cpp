// Copy-and-patch JIT stencil library (raw speed phase 4, r21).
//
// Each function below is ONE parameterized tick fragment: the pass-1
// (fetch + phase A + source resolution) or pass-2 (arbitration + commit)
// body of a single baked (lane, pc) instruction, semantically identical
// to the matching arm of group_tick in native/interpreter.cpp (and to the
// switch case core/specialize.py generates for the switch-threaded tier).
// The per-instruction constants — flat replica-plane bases, port/stack
// indices, immediates, pc successors, jump targets — are "holes": each is
// the ADDRESS of an undefined extern symbol (misaka_hole_K), taken as an
// int64 value.  Compiled with `-c -fno-pic -mcmodel=large`, every hole
// reference becomes a `movabs $imm64` carrying an R_X86_64_64 relocation
// against the hole symbol, so core/jit.py can compile this file ONCE
// (content-keyed in the spec cache), read the relocation table straight
// out of the .o, and then splice + patch fragments per (lane, pc) into an
// executable buffer in microseconds — no per-program C++ compile at all.
//
// Self-containment contract: a stencil may not reference ANYTHING outside
// its own section except the holes — no calls, no rodata, no TLS, no
// jump tables (the build forces -fno-jump-tables -fno-stack-protector
// -fno-exceptions).  core/jit.py verifies this: any relocation that is
// not an R_X86_64_64 against a misaka_hole_* symbol rejects the whole
// library and the ladder falls back one rung to the switch-threaded tier.
//
// ABI: MisakaJitCtx below MUST match native/interpreter.cpp's definition
// field-for-field; both sides carry MISAKA_JIT_ABI and the arm call
// rejects a mismatch (falling back one rung, never corrupting).

#include <cstdint>

#define MISAKA_JIT_ABI 1

// Raw pointers into one Group's SoA planes + the in-flight tick's
// scratch (moved[] and the TickIO arrays live on the driver's stack).
// Keep in lockstep with native/interpreter.cpp (MISAKA_JIT_ABI).
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

// Parameter holes: undefined symbols whose ADDRESSES are the patch sites.
// Never defined anywhere — the .o is parsed, never linked.
extern "C" char misaka_hole_0, misaka_hole_1, misaka_hole_2, misaka_hole_3,
    misaka_hole_4, misaka_hole_5, misaka_hole_6, misaka_hole_7;

// A hole's int64 value.  NEVER use a hole in a truthiness/nullness test:
// the compiler may fold `&extern_sym != 0` to true.  Holes are only ever
// indices, immediates and pc targets below.
#define P0 ((int64_t)(intptr_t)&misaka_hole_0)
#define P1 ((int64_t)(intptr_t)&misaka_hole_1)
#define P2 ((int64_t)(intptr_t)&misaka_hole_2)
#define P3 ((int64_t)(intptr_t)&misaka_hole_3)
#define P4 ((int64_t)(intptr_t)&misaka_hole_4)

static inline int32_t i32(int64_t v) {
  return (int32_t)(uint32_t)(uint64_t)v;
}

// The shared commit tail (group_tick: moved, pc successor, latch clear,
// wrap-safe retired advance).  `nxt` is already the baked successor.
static inline void tail(MisakaJitCtx* c, uint64_t r, int64_t i,
                        int64_t nxt) {
  c->moved[r] = 1;
  c->pc[i] = (int32_t)nxt;
  c->holding[i] = 0;
  c->retired[i] = i32((int64_t)c->retired[i] + 1);
}

extern "C" {

// --- pass 1: phase A + source resolution (P0 = lane plane base l*W) --------

// reading op, port source: consume a ready port into the hold latch, then
// resolve from the latch.  P1 = (l*kPorts + (src-R0))*W.
void misaka_st1_port(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  const int64_t pi = P1 + (int64_t)r;
  if (!c->holding[i] && c->port_full[pi]) {
    c->hold_val[i] = c->port_val[pi];
    c->holding[i] = 1;
    c->port_full[pi] = 0;
    c->moved[r] = 1;
  }
  c->s_src_val[i] = (int64_t)c->hold_val[i];
  c->s_src_ok[i] = (uint8_t)(c->holding[i] != 0);
}

// reading op, immediate source.  P1 = sign-extended immediate.
void misaka_st1_imm(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  c->s_src_val[i] = P1;
  c->s_src_ok[i] = 1;
}

// reading op, ACC source.
void misaka_st1_acc(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  c->s_src_val[i] = c->acc[i];
  c->s_src_ok[i] = 1;
}

// NIL source / non-reading op: resolved-and-ready with value 0.
void misaka_st1_zero(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  c->s_src_val[i] = 0;
  c->s_src_ok[i] = 1;
}

// --- pass 2: arbitration + commit ------------------------------------------
// Every fragment opens with the source-readiness guard (s_src_ok is 1 for
// non-reading ops by pass-1 construction, so the check is universal).

// MOV <src>, <lane>.<port>: P1 = (tgt*kPorts + port)*W, P2 = nxt.
void misaka_st2_mov_net(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  const int64_t pi = P1 + (int64_t)r;
  if (c->port_full[pi] || c->s_deliv_full[pi]) return;
  c->s_deliv_full[pi] = 1;
  c->s_deliv_val[pi] = i32(c->s_src_val[i]);
  tail(c, r, i, P2);
}

// PUSH <src>, <stack>: P1 = tgt*W, P2 = stack_cap, P3 = nxt.
void misaka_st2_push(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  const int64_t si = P1 + (int64_t)r;
  if (c->s_stack_taken[si] || c->s_begin_top[si] >= (int32_t)P2) return;
  c->s_stack_taken[si] = 1;
  c->s_pushed[si] = 1;
  c->s_push_val[si] = i32(c->s_src_val[i]);
  tail(c, r, i, P3);
}

// POP <stack> -> ACC: P1 = tgt*W, P2 = num_stacks*stack_cap (replica
// stride), P3 = tgt*stack_cap (stack offset), P4 = nxt.
void misaka_st2_pop_acc(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  const int64_t si = P1 + (int64_t)r;
  if (c->s_stack_taken[si] || c->s_begin_top[si] <= 0) return;
  c->s_stack_taken[si] = 1;
  c->acc[i] = (int64_t)c->stack_mem[(int64_t)r * P2 + P3 +
                                    (int64_t)c->s_begin_top[si] - 1];
  tail(c, r, i, P4);
}

// POP <stack> -> NIL (a granted pop with the value discarded): P1 = tgt*W,
// P2 = nxt.
void misaka_st2_pop_nil(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  const int64_t si = P1 + (int64_t)r;
  if (c->s_stack_taken[si] || c->s_begin_top[si] <= 0) return;
  c->s_stack_taken[si] = 1;
  tail(c, r, i, P2);
}

// IN -> ACC: P1 = lane index (the arbitration winner tag), P2 = in_cap,
// P3 = nxt.
void misaka_st2_in_acc(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  if (!c->io_in_avail[r] || c->io_in_taken[r]) return;
  c->io_in_taken[r] = 1;
  c->io_in_win[r] = (int32_t)P1;
  c->acc[i] = (int64_t)c->in_buf[(int64_t)r * P2 +
                                 (int64_t)((uint32_t)c->in_rd[r] %
                                           (uint32_t)P2)];
  tail(c, r, i, P3);
}

// IN -> NIL: P1 = lane index, P2 = nxt.
void misaka_st2_in_nil(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  if (!c->io_in_avail[r] || c->io_in_taken[r]) return;
  c->io_in_taken[r] = 1;
  c->io_in_win[r] = (int32_t)P1;
  tail(c, r, i, P2);
}

// OUT <src>: P1 = nxt.
void misaka_st2_out(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  if (!c->io_out_free[r] || c->io_out_taken[r]) return;
  c->io_out_taken[r] = 1;
  c->io_out_value[r] = i32(c->s_src_val[i]);
  tail(c, r, i, P1);
}

// JRO <src>: P1 = this pc, P2 = prog_len - 1 (the clamp bound).
void misaka_st2_jro(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  const int64_t v = c->s_src_val[i];
  const int64_t mx = P2;
  const int64_t t =
      (v >= INT32_MIN && v <= INT32_MAX) ? P1 + v : (v < 0 ? 0 : mx);
  c->moved[r] = 1;
  c->pc[i] = (int32_t)(t < 0 ? 0 : (t > mx ? mx : t));
  c->holding[i] = 0;
  c->retired[i] = i32((int64_t)c->retired[i] + 1);
}

// JMP: P1 = target.
void misaka_st2_jmp(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  tail(c, r, i, P1);
}

// Conditional jumps: P1 = taken target, P2 = nxt.
void misaka_st2_jez(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  tail(c, r, i, c->acc[i] == 0 ? P1 : P2);
}

void misaka_st2_jnz(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  tail(c, r, i, c->acc[i] != 0 ? P1 : P2);
}

void misaka_st2_jgz(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  tail(c, r, i, c->acc[i] > 0 ? P1 : P2);
}

void misaka_st2_jlz(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  tail(c, r, i, c->acc[i] < 0 ? P1 : P2);
}

// MOV <src> -> ACC: P1 = nxt.
void misaka_st2_mov_acc(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  c->acc[i] = c->s_src_val[i];
  tail(c, r, i, P1);
}

// Commit with no register effect (NOP, MOV -> NIL): P1 = nxt.
void misaka_st2_none(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  tail(c, r, i, P1);
}

// ADD/SUB/NEG/SWP/SAV: 64-bit register arithmetic (wrap-safe through
// uint64, wire truncation happens at MOV_NET/OUT/PUSH sites): P1 = nxt.
void misaka_st2_add(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  c->acc[i] = (int64_t)((uint64_t)c->acc[i] + (uint64_t)c->s_src_val[i]);
  tail(c, r, i, P1);
}

void misaka_st2_sub(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  c->acc[i] = (int64_t)((uint64_t)c->acc[i] - (uint64_t)c->s_src_val[i]);
  tail(c, r, i, P1);
}

void misaka_st2_neg(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  c->acc[i] = (int64_t)(0 - (uint64_t)c->acc[i]);
  tail(c, r, i, P1);
}

void misaka_st2_swp(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  const int64_t oa = c->acc[i];
  c->acc[i] = c->bak[i];
  c->bak[i] = oa;
  tail(c, r, i, P1);
}

void misaka_st2_sav(MisakaJitCtx* c, uint64_t r) {
  const int64_t i = P0 + (int64_t)r;
  if (!c->s_src_ok[i]) return;
  c->bak[i] = c->acc[i];
  tail(c, r, i, P1);
}

}  // extern "C"
